"""The port's twin of ``examples/llama_pretrain.py``
(``python -m paddle_tpu_torch.examples.llama_pretrain``): the reference's
flags and defaults, a run on the CPU at tiny flags, the refusals of what
is not ported (a mesh), and ``--save``'s checkpoint pair read back by
both packages."""

import ast
import os

import pytest

from paddle_tpu_torch.examples import llama_pretrain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--hidden", "64", "--intermediate", "128",
        "--layers", "2", "--heads", "4", "--kv-heads", "2", "--vocab", "256",
        "--batch", "2", "--seq", "16", "--steps", "3", "--lr", "3e-3"]


def _reference_flags():
    """``{dest: default}`` of the JAX example's ``add_argument`` calls."""
    path = os.path.join(REPO, "examples", "llama_pretrain.py")
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    flags = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                getattr(node.func, "attr", "") == "add_argument":
            dest = node.args[0].value.lstrip("-").replace("-", "_")
            kw = {k.arg: k.value for k in node.keywords}
            flags[dest] = ast.literal_eval(kw["default"]) \
                if "default" in kw else None
    return flags


def test_flags_and_defaults_are_the_reference_s():
    want = _reference_flags()
    got = vars(llama_pretrain.parse_args([]))
    assert got.pop("device") is None
    assert got == want
    assert (got["hidden"], got["layers"], got["heads"], got["kv_heads"],
            got["vocab"], got["batch"], got["seq"]) == \
        (2048, 16, 32, 8, 32000, 8, 2048)


@pytest.mark.parametrize("accumulate", ["1", "2"])
def test_runs_on_the_cpu_at_tiny_flags(accumulate, capsys):
    losses = llama_pretrain.main(TINY + ["--accumulate", accumulate])
    out = capsys.readouterr().out
    assert "step 0 (compile): loss" in out and "step 3: loss" in out
    assert len(losses) == 4 and all(x == x for x in losses)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("flag,item", [
    (["--dp", "2"], "item 14"), (["--mp", "2"], "item 14"),
    (["--zero", "os"], "item 14"), (["--sharding", "2"], "item 14")])
def test_unported_flags_raise(flag, item):
    with pytest.raises(NotImplementedError, match=item):
        llama_pretrain.main(TINY + flag)


def test_save_writes_the_reference_checkpoint_pair(tmp_path):
    """``--save PREFIX`` writes ``PREFIX.pdparams`` (the model's state
    dict) and ``PREFIX.pdopt`` (the optimizer's ``state_dict()``) in the
    reference's envelope: the port loads them back, and the JAX
    package's ``paddle.load`` reads the same arrays.  ``TrainStep`` keeps
    its moments in the step, not in the optimizer, in both packages, so
    ``.pdopt`` holds no moment after a run (the reference's example
    writes the same)."""
    import numpy as np
    import torch

    import paddle_tpu as jpaddle
    import paddle_tpu_torch as paddle
    prefix = str(tmp_path / "ckpt")
    llama_pretrain.main(TINY + ["--steps", "1", "--save", prefix])
    params = paddle.load(prefix + ".pdparams")
    opt = paddle.load(prefix + ".pdopt")
    assert params and all(isinstance(v, torch.Tensor)
                          for v in params.values())
    assert opt == {} and jpaddle.load(prefix + ".pdopt") == {}
    jparams = jpaddle.load(prefix + ".pdparams")
    assert sorted(jparams) == sorted(params)
    for k, v in params.items():
        np.testing.assert_array_equal(
            np.asarray(jparams[k]._value.astype("float32")),
            v.float().numpy(), err_msg=k)
