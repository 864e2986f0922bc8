"""The port's twin of ``examples/llama_serve.py``
(``python -m paddle_tpu_torch.examples.llama_serve``), run on the CPU:
steps 1-3 print, the artifact round trip reproduces the session, and the
twin's flags are the reference's (none) plus ``--device``."""

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
    for tag in ("generate:", "session :", "artifact:"):
        assert tag in printed
    assert out["generate"].shape == out["session"].shape == (2, 12)
    np.testing.assert_array_equal(out["artifact"], out["session"])
    assert (out["session"] >= 0).all() and (out["session"] < 256).all()


def test_flags():
    assert vars(llama_serve.parse_args([])) == {"device": None}
