"""The port's twin of ``examples/llama_serve.py``
(``python -m paddle_tpu_torch.examples.llama_serve``), run on the CPU:
the four steps print, the artifact round trip reproduces the session,
step 4 serves the converted copy, and the twin's flags are the
reference's (none) plus ``--device``."""

import numpy as np
import torch

from paddle_tpu_torch.examples import llama_serve


def test_runs_on_the_cpu_and_the_artifact_reproduces(capsys):
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = llama_serve.main(["--device", "cpu"])
    finally:
        torch.set_num_threads(prev)
    printed = capsys.readouterr().out
    for tag in ("generate:", "session :", "artifact:", "int8    :"):
        assert tag in printed
    assert out["generate"].shape == out["session"].shape == (2, 12)
    assert out["int8"].shape == (2, 12)
    assert (out["int8"] >= 0).all() and (out["int8"] < 256).all()
    np.testing.assert_array_equal(out["artifact"], out["session"])
    assert (out["session"] >= 0).all() and (out["session"] < 256).all()


def test_flags():
    assert vars(llama_serve.parse_args([])) == {"device": None}
