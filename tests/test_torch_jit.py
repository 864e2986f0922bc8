"""The port's ``jit`` (``to_static``, ``save``/``load``, the shape
bucketing helpers) and the kernels as dispatcher ops, held against the
JAX package on the CPU:

- the ``to_static``/``jit.save`` cases of ``tests/test_amp_io_jit.py``
  (:140-214) and the export half of its :293 (``Model.save(training=
  False)``), on the same numpy inputs and bridged weights, within
  ``rtol 1e-5``;
- ``tests/test_bucketing.py`` case for case;
- the artifact carries the kernels: a saved tiny Llama's program calls
  ``paddle_tpu_torch::rms_norm``, ``::apply_rope`` and
  ``::flash_attention_fwd`` and no bare ``aten.rsqrt``; a converted one's
  under ``FLAGS_use_int8_matmul_kernel`` calls ``::quantized_matmul``;
- neither package loads the other's artifact;
- the three kernel wrappers made dispatcher ops (``ops._dispatch``) are
  bit-equal to their plain versions on the CPU, and their gradients are
  the plain math's.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu_torch as tpt
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.jit import (BucketedFunction, InputSpec, bucketed,
                                  default_buckets, pad_to_bucket)
from paddle_tpu_torch.ops import quantized_matmul as tqmm
from paddle_tpu_torch.ops import rms_norm as trn
from paddle_tpu_torch.ops import rope as trp

REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def a(*shape):
    return np.random.default_rng(5).standard_normal(shape).astype(np.float32)


def _np(v):
    return np.asarray(v._value) if hasattr(v, "_value") else \
        v.detach().cpu().numpy()


def _bridge_linear(jlin, tlin):
    with torch.no_grad():
        tlin.weight.copy_(torch.tensor(np.asarray(jlin.weight._value)).t())
        tlin.bias.copy_(torch.tensor(np.asarray(jlin.bias._value)))


def _mlp_pair(sizes, act=("ReLU",)):
    """The same Sequential of Linears in both packages, bridged."""
    jl, tl = [], []
    for i, (n_in, n_out) in enumerate(zip(sizes, sizes[1:])):
        j, t = jnn.Linear(n_in, n_out), tnn.Linear(n_in, n_out, device="cpu")
        _bridge_linear(j, t)
        jl.append(j)
        tl.append(t)
        if i < len(sizes) - 2:
            jl.append(getattr(jnn, act[0])())
            tl.append(getattr(tnn, act[0])())
    return jnn.Sequential(*jl), tnn.Sequential(*tl)


# ---------------------------------------------------------------------------
# tests/test_amp_io_jit.py :140-214 and the export half of :293
# ---------------------------------------------------------------------------

def test_to_static_function():
    calls, rcalls = [], []

    @paddle.jit.to_static
    def rf(x, y):
        rcalls.append(1)
        return paddle.matmul(x, y) + 1.0

    @tjit.to_static
    def f(x, y):
        calls.append(1)
        return torch.matmul(x, y) + 1.0

    xv, yv = a(3, 4), a(4, 2)
    want = _np(rf(paddle.to_tensor(xv), paddle.to_tensor(yv)))
    for _ in range(2):
        got = f(torch.tensor(xv), torch.tensor(yv))
        np.testing.assert_allclose(got.numpy(), want, rtol=REL)
    np.testing.assert_allclose(want, xv @ yv + 1, rtol=REL)
    # eager: one run of the function a call
    assert len(calls) == 2


def test_to_static_layer_with_params_and_backward():
    jnet, tnet = _mlp_pair((4, 2))
    jnet, tnet = jnet[0], tnet[0]

    @paddle.jit.to_static
    def rstep(x):
        return jnet(x).sum()

    @tjit.to_static
    def step(x):
        return tnet(x).sum()

    xv = a(3, 4)
    rloss, loss = rstep(paddle.to_tensor(xv)), step(torch.tensor(xv))
    rloss.backward()
    loss.backward()
    np.testing.assert_allclose(tnet.weight.grad.numpy().T,
                               _np(jnet.weight.grad), rtol=REL)
    np.testing.assert_allclose(tnet.weight.grad.numpy().T,
                               np.tile(xv.sum(0)[:, None], (1, 2)), rtol=REL)
    # a parameter update is seen by the next call
    old = float(step(torch.tensor(xv)))
    with torch.no_grad():
        tnet.weight.zero_()
        tnet.bias.zero_()
    assert float(step(torch.tensor(xv))) == pytest.approx(0.0, abs=1e-6)
    assert old == pytest.approx(float(rloss), rel=REL) and old != 0.0


def test_to_static_shape_recompile():
    @tjit.to_static
    def f(x):
        return (x * 2).sum()

    @paddle.jit.to_static
    def rf(x):
        return (x * 2).sum()

    for n in (3, 5):
        assert float(f(torch.ones(n))) == float(rf(paddle.to_tensor(
            np.ones(n, np.float32)))) == 2.0 * n


class _RefNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = jnn.Linear(2, 2)

    @paddle.jit.to_static
    def forward(self, x):
        return self.fc(x)


class _PortNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = tnn.Linear(2, 2, device="cpu")

    @tjit.to_static
    def forward(self, x):
        return self.fc(x)


def test_to_static_method_decorator():
    rnet, net = _RefNet(), _PortNet()
    _bridge_linear(rnet.fc, net.fc)
    xv = a(1, 2)
    out = net(torch.tensor(xv))
    assert tuple(out.shape) == (1, 2)
    np.testing.assert_allclose(out.detach().numpy(),
                               _np(rnet(paddle.to_tensor(xv))), rtol=REL)


def test_jit_save_load(tmp_path):
    jnet, tnet = _mlp_pair((4, 8, 2))
    xv = a(2, 4)
    paddle.jit.save(jnet, str(tmp_path / "r"),
                    input_spec=[paddle.static.InputSpec([2, 4], "float32")])
    tjit.save(tnet, str(tmp_path / "p"),
              input_spec=[InputSpec([2, 4], "float32")])
    want = _np(paddle.jit.load(str(tmp_path / "r"))(paddle.to_tensor(xv)))
    got = tjit.load(str(tmp_path / "p"), device="cpu")(torch.tensor(xv))
    np.testing.assert_allclose(got.numpy(), want, rtol=REL, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), tnet(torch.tensor(xv))
                               .detach().numpy(), rtol=0, atol=0)


def test_model_save_training_false_exports(tmp_path):
    """The export half of ``test_model_amp_o1_and_o2_and_inference_export``:
    ``Model.save(training=False)`` writes the artifact ``jit.load`` reads,
    and without input specs raises the reference's ``ValueError``."""
    jnet, tnet = _mlp_pair((8, 1))
    jm = paddle.Model(jnet[0], inputs=[paddle.static.InputSpec((2, 8),
                                                               "float32")])
    tm = tpt.Model(tnet[0], inputs=[InputSpec((2, 8), "float32")])
    for m in (jm, tm):
        m.prepare(loss=(jnn if m is jm else tnn).MSELoss())
    jm.save(str(tmp_path / "r"), training=False)
    tm.save(str(tmp_path / "p"), training=False)
    xv = a(2, 8)
    want = _np(paddle.jit.load(str(tmp_path / "r"))(paddle.to_tensor(xv)))
    got = tjit.load(str(tmp_path / "p"), device="cpu")(torch.tensor(xv))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    with pytest.raises(ValueError, match="input spec"):
        tpt.Model(tnn.Linear(2, 2, device="cpu")).save(
            str(tmp_path / "x"), training=False)


# ---------------------------------------------------------------------------
# tests/test_bucketing.py
# ---------------------------------------------------------------------------

def test_default_buckets_ladder():
    from paddle_tpu.jit import default_buckets as rdb
    assert default_buckets(128, 8) == rdb(128, 8) == [8, 16, 32, 64, 128]
    assert default_buckets(100, 8)[-1] == rdb(100, 8)[-1] == 100


def test_pad_to_bucket_and_mask():
    from paddle_tpu.jit import pad_to_bucket as rpad
    x = np.ones((2, 11), np.float32)
    padded, size, mask = pad_to_bucket(torch.tensor(x), 1, [8, 16, 32])
    rp, rsize, rmask = rpad(paddle.to_tensor(x), 1, [8, 16, 32])
    assert tuple(padded.shape) == tuple(rp.shape) == (2, 16)
    assert size == rsize == 11
    np.testing.assert_array_equal(mask.numpy(), _np(rmask))
    np.testing.assert_array_equal(padded.numpy(), _np(rp))
    padded2, size2, _ = pad_to_bucket(torch.tensor(x), 1, [11, 16])
    assert tuple(padded2.shape) == (2, 11) and size2 == 11


def test_pad_to_bucket_overflow_raises():
    from paddle_tpu.jit import pad_to_bucket as rpad
    x = np.ones((2, 64), np.float32)
    with pytest.raises(ValueError, match="largest bucket"):
        pad_to_bucket(torch.tensor(x), 1, [8, 16])
    with pytest.raises(ValueError, match="largest bucket"):
        rpad(paddle.to_tensor(x), 1, [8, 16])


def test_bucketed_function_bounds_compiles(tmp_path):
    """Every bucket is one exported program: five differently sized calls
    give two shapes, as the reference's two jit traces."""
    seen = []

    def core(x):
        seen.append(tuple(x.shape))
        return x * 2

    bf = BucketedFunction(core, axes={0: (1, [8, 16], 0.0)}, crop=(1,))
    for n in (3, 5, 7, 8):
        out = bf(torch.ones((1, n)))
        assert tuple(out.shape) == (1, n)
        np.testing.assert_allclose(out.numpy(), 2.0)
    out = bf(torch.ones((1, 12)))
    assert tuple(out.shape) == (1, 12)
    assert len(set(seen)) == 2 and len(bf.compiled_shapes) == 2


def test_bucketed_decorator_with_loss_mask():
    emb = tnn.Embedding(16, 4, device="cpu")

    @bucketed(axes={0: (1, [8, 16], 0)}, crop=(1,))
    def forward(ids):
        return emb(ids)

    out = forward(torch.arange(5)[None])
    assert tuple(out.shape) == (1, 5, 4)
    np.testing.assert_array_equal(out.detach().numpy()[0],
                                  emb.weight.detach().numpy()[:5])


def test_crop_skips_scalar_outputs():
    lin = tnn.Linear(4, 4, device="cpu")

    @bucketed(axes={0: (1, [8], 0.0)}, crop=(1,))
    def fwd_with_loss(x):
        out = lin(x)
        return out, out.sum()

    out, loss = fwd_with_loss(torch.ones((1, 5, 4)))
    assert tuple(out.shape) == (1, 5, 4) and loss.ndim == 0


def test_jitter_tuple_validation():
    from paddle_tpu.vision import transforms as RT
    from paddle_tpu_torch.vision import transforms as T
    for mod in (RT, T):
        with pytest.raises(ValueError, match="lo <= hi"):
            mod.BrightnessTransform((1.5, 0.5))
        with pytest.raises(ValueError, match="lo <= hi"):
            mod.ContrastTransform((-0.5, 0.5))


def test_cuda_out_of_range_raises():
    """The reference's ``Tensor.cuda(99)`` refuses a device that is not
    there; the port's device resolution refuses a CUDA device without a
    card, and a device type that is neither."""
    from paddle_tpu_torch.device import resolve_device
    with pytest.raises(ValueError, match="out of range"):
        paddle.to_tensor(np.ones(2, np.float32)).cuda(99)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device("cuda:99")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        resolve_device("meta")


def test_bucketed_crop_keeps_gradients():
    lin = tnn.Linear(4, 4, device="cpu")

    @bucketed(axes={0: (1, [8], 0.0)}, crop=(1,))
    def fwd(x):
        return lin(x)

    x = torch.ones((1, 5, 4), requires_grad=True)
    fwd(x).sum().backward()
    gx = x.grad.numpy()
    assert gx.shape == (1, 5, 4)
    np.testing.assert_allclose(gx[0], np.tile(
        lin.weight.detach().numpy().sum(axis=0), (5, 1)), atol=1e-5)
    np.testing.assert_allclose(lin.weight.grad.numpy(),
                               np.full((4, 4), 5.0), atol=1e-5)


# ---------------------------------------------------------------------------
# the artifact carries the kernels; cross-package artifacts
# ---------------------------------------------------------------------------

def _targets(prefix):
    from paddle_tpu_torch.jit.api import Artifact
    counts = {}
    for n in Artifact(prefix).program.graph.nodes:
        if n.op == "call_function":
            counts[str(n.target)] = counts.get(str(n.target), 0) + 1
    return counts


@pytest.fixture(scope="module")
def tiny_llama(tmp_path_factory):
    from paddle_tpu_torch.models import LlamaForCausalLM, tiny_llama_config
    cfg = tiny_llama_config()
    model = LlamaForCausalLM(cfg, device="cpu", seed=3)
    prefix = str(tmp_path_factory.mktemp("llama") / "llama")
    tjit.save(model, prefix, input_spec=[InputSpec([2, 16], "int64")])
    return cfg, model, prefix


def test_artifact_calls_the_kernel_ops(tiny_llama):
    cfg, model, prefix = tiny_llama
    ops = _targets(prefix)
    nl = cfg.num_hidden_layers
    assert ops.get("paddle_tpu_torch.rms_norm.default") == 2 * nl + 1
    assert ops.get("paddle_tpu_torch.apply_rope.default") == 2 * nl
    assert ops.get("paddle_tpu_torch.flash_attention_fwd.default") == nl
    assert not any("rsqrt" in k for k in ops), ops
    # the program holds no weights: they are its inputs, in the params file
    import os
    sizes = {sfx: os.path.getsize(prefix + sfx)
             for sfx in (".ptpu_torch_model", ".ptpu_params")}
    weights = sum(p.numel() * p.element_size()
                  for p in model.state_dict().values())
    assert sizes[".ptpu_params"] > weights > 2 * sizes[".ptpu_torch_model"]


def test_converted_artifact_calls_the_quantized_matmul(tmp_path):
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.models import LlamaForCausalLM, tiny_llama_config
    from paddle_tpu_torch.quantization import weight_only_quantize
    cfg = tiny_llama_config()
    model = LlamaForCausalLM(cfg, device="cpu", seed=4)
    weight_only_quantize(model, skip=lambda name, _l: name == "lm_head")
    ids = torch.randint(0, cfg.vocab_size, (2, 8))
    for on in (True, False):
        set_flags({"FLAGS_use_int8_matmul_kernel": on})
        try:
            tjit.save(model, str(tmp_path / f"q{on}"),
                      input_spec=[InputSpec([2, 8], "int64")])
            want = model(ids)
        finally:
            set_flags({"FLAGS_use_int8_matmul_kernel": False})
        ops = _targets(str(tmp_path / f"q{on}"))
        # the flag read at export is baked into the program
        assert ops.get("paddle_tpu_torch.quantized_matmul.default", 0) == \
            (7 * cfg.num_hidden_layers if on else 0), ops
        got = tjit.load(str(tmp_path / f"q{on}"), device="cpu")(ids)
        assert torch.equal(got, want)


def test_cross_package_artifacts_raise(tmp_path):
    jnet, tnet = _mlp_pair((4, 2))
    paddle.jit.save(jnet, str(tmp_path / "r"),
                    input_spec=[paddle.static.InputSpec([2, 4], "float32")])
    tjit.save(tnet, str(tmp_path / "p"),
              input_spec=[InputSpec([2, 4], "float32")])
    with pytest.raises(ValueError, match="Known differences of jit"):
        tjit.load(str(tmp_path / "r"), device="cpu")
    with pytest.raises(FileNotFoundError):
        paddle.jit.load(str(tmp_path / "p"))
    from paddle_tpu_torch import inference
    cfg = inference.Config(str(tmp_path / "r"))
    cfg.disable_gpu()
    with pytest.raises(ValueError, match="Known differences of jit"):
        inference.create_predictor(cfg)


# ---------------------------------------------------------------------------
# the kernels as dispatcher ops: contracts on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_op_bits_and_gradients(dtype):
    rng = np.random.default_rng(6)
    x = torch.tensor(rng.standard_normal((3, 5, 64)).astype(np.float32)) \
        .to(dtype)
    w = torch.tensor((1 + 0.1 * rng.standard_normal(64)).astype(np.float32)) \
        .to(dtype)
    g = torch.tensor(rng.standard_normal((3, 5, 64)).astype(np.float32)) \
        .to(dtype)
    y = torch.ops.paddle_tpu_torch.rms_norm(x, w, 1e-5)
    assert torch.equal(y, trn.rms_norm_plain(x, w, 1e-5))
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    trn.rms_norm(xg, wg, 1e-5).backward(g)
    dx, dw = trn.rms_norm_bwd(x, w, g, 1e-5)
    assert torch.equal(xg.grad, dx) and torch.equal(wg.grad, dw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_op_bits_and_gradients(dtype):
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.standard_normal((2, 6, 3, 16)).astype(np.float32)) \
        .to(dtype)
    th = rng.standard_normal((1, 6, 1, 8)).astype(np.float32)
    cos, sin = torch.tensor(np.cos(th)), torch.tensor(np.sin(th))
    g = torch.tensor(rng.standard_normal((2, 6, 3, 16)).astype(np.float32)) \
        .to(dtype)
    y = torch.ops.paddle_tpu_torch.apply_rope(x, cos, sin, 1.0)
    assert torch.equal(y, trp.apply_rope_plain(x, cos, sin))
    xg = x.clone().requires_grad_()
    trp.apply_rope(xg, cos, sin).backward(g)
    assert torch.equal(xg.grad, trp.apply_rope_plain(g, cos, -sin))


def test_quantized_matmul_op_bits_and_gradients():
    rng = np.random.default_rng(8)
    x = torch.tensor(rng.standard_normal((5, 32)).astype(np.float32))
    codes = torch.tensor(rng.integers(-127, 128, (32, 16)), dtype=torch.int8)
    scales = torch.tensor(rng.random(16).astype(np.float32) * 0.01)
    bias = torch.tensor(rng.standard_normal(16).astype(np.float32))
    for b, act in ((None, None), (bias, "gelu")):
        got = torch.ops.paddle_tpu_torch.quantized_matmul(
            x, codes, scales, torch.float32, b, act, 8)
        assert torch.equal(got, tqmm.quantized_matmul_plain(
            x, codes, scales, bias=b, act=act))
    g = torch.tensor(rng.standard_normal((5, 16)).astype(np.float32))
    xg = x.clone().requires_grad_()
    tqmm.quantized_matmul(xg, codes, scales).backward(g)
    w = codes.float() * scales[None, :]
    assert torch.equal(xg.grad, g @ w.t())
    with pytest.raises(RuntimeError, match="only the int8 form"):
        tqmm.quantized_matmul(xg, codes, scales, bias=bias)


def test_llama_dynamic_batch_exports_in_the_port_only(tiny_llama, tmp_path):
    """The reference's Llama exports only at static shapes: at
    ``InputSpec([None, 16])`` its ``jax.export`` raises (an ``int()`` of a
    symbolic dimension, ``paddle_tpu/tensor/_helpers.py:44``); the
    port's program takes any batch (ROADMAP.md, Queue 3, "Reference
    findings, not port faults")."""
    from paddle_tpu import models as jmodels
    cfg, model, _ = tiny_llama
    paddle.seed(0)
    jnet = jmodels.LlamaForCausalLM(jmodels.tiny_llama_config())
    with pytest.raises(Exception, match="Inconclusive|symbolic|dimension"):
        paddle.jit.save(jnet, str(tmp_path / "r"),
                        input_spec=[paddle.static.InputSpec([None, 16],
                                                            "int32")])
    tjit.save(model, str(tmp_path / "p"),
              input_spec=[InputSpec([None, 16], "int64")])
    loaded = tjit.load(str(tmp_path / "p"), device="cpu")
    for b in (1, 3):
        ids = torch.randint(0, cfg.vocab_size, (b, 16))
        assert torch.equal(loaded(ids), model(ids))
