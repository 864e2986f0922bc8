"""The port's registry sweep, held against the reference's.

Every op of the port's registry (``paddle_tpu_torch/ops/ops.yaml``, the
reference's entry for entry) runs on the inputs the reference's sweep
builds (``tests/test_op_sweep.py``: ``_auto_inputs``, ``_float_t`` and
``op_sweep_spec.CUSTOM_INPUTS``, its ``SKIP`` honoured with its
reasons), carried to the port through numpy:

1. forward: the same number of outputs, dtype names equal, float
   results within 1e-5 of the largest entry, integers and bools exact;
2. gradient, for the float tensor inputs: torch autograd of the summed
   float outputs against the reference's tape, within the same
   tolerance.

The reference's finite differences and bf16 check are not re-run (its
own sweep does both).  Random ops: the threefry draws (``rand``,
``uniform``, ``randint``, ``bernoulli``, ``randperm``, ``uniform_`` and
the dropout family) are bit-equal for one seed; the normals within
1e-5; the law-only draws (``multinomial``, ``poisson``, ``binomial``,
``standard_gamma``, ``exponential_``, ...) are held by shape and dtype
here and by their moments in ``test_torch_tensor_ops.py``.  The cases
are split over three files (this one and ``_b``, ``_c``) so that
``--dist loadfile`` spreads them.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
import test_op_sweep as ref_sweep
from op_sweep_spec import SKIP
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.ops.registry import registry as jregistry
from paddle_tpu.ops.registry import resolve as jresolve
from paddle_tpu_torch.core.dtypes import dtype_name
from paddle_tpu_torch.ops.registry import registry_by_name

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_JSPECS = {s.op: s for s in jregistry()}
_TSPECS = registry_by_name()

def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_sweep", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the sweep's classes of ops, shared with the card's sweep (chip_smoke
# phase 8c (e)): threefry draws bit-equal to the reference's for one seed;
# draws through the same uniforms and torch's erfinv; draws that follow
# the reference's law only (their moments: test_torch_tensor_ops.py);
# ops whose gradient is not compared, each with its reason; output slots
# of singular/eigen vectors, whose signs are free
SMOKE = _smoke()
BITS, ULPS, LAW = SMOKE.SWEEP_BITS, SMOKE.SWEEP_ULPS, SMOKE.SWEEP_LAW
NO_GRAD, SIGNED = SMOKE.SWEEP_NO_GRAD, SMOKE.SWEEP_SIGNED
# further cases the port does not hold here, with the reason
PORT_SKIP = {}

ALL = sorted(op for op in _TSPECS if op not in SKIP and op not in PORT_SKIP)


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    from paddle_tpu_torch import device as tdevice
    prev = tdevice._layer_device
    pt.set_device("cpu")
    yield
    tdevice._layer_device = prev


def _port(v):
    """A reference input as the port's: a tensor through numpy (its own
    copy), containers element by element."""
    if isinstance(v, JTensor):
        t = pt.to_tensor(np.array(v._value, copy=True), place="cpu")
        if not v.stop_gradient:
            t.stop_gradient = False
        return t
    if isinstance(v, (list, tuple)):
        return type(v)(_port(x) for x in v)
    return v


def _build(op):
    spec = _JSPECS[op]
    args, kwargs = ref_sweep._auto_inputs(spec, jresolve(spec))
    return list(args), dict(kwargs)


def _flat(out, cls):
    if isinstance(out, cls):
        return [out]
    if isinstance(out, (tuple, list)):
        flat = []
        for o in out:
            flat.extend(_flat(o, cls))
        return flat
    return []


def _j_np(t):
    return np.asarray(t._value)


def _close(op, what, got, want, tol=1e-5, floor=1e-30):
    """Float results within ``tol`` of the largest entry (of
    ``max(largest, floor)``: gradients use 1, so a gradient that is zero
    in exact arithmetic is held to float32 noise), others exact."""
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (op, what, got.shape, want.shape)
    if want.dtype.kind in "fc" or want.dtype.name == "bfloat16":
        w = want.astype(np.complex64 if want.dtype.kind == "c"
                        else np.float32)
        g = got.astype(w.dtype)
        scale = max(float(np.max(np.abs(w))) if w.size else 0.0, floor)
        finite = np.isfinite(w)
        assert np.array_equal(finite, np.isfinite(g)), (op, what)
        err = float(np.max(np.abs(g[finite] - w[finite]))) \
            if finite.any() else 0.0
        assert err <= tol * scale, (op, what, err, scale)
    else:
        assert np.array_equal(got, want), (op, what, got, want)


def _compare_outputs(op, jout, tout, tol=1e-5):
    jf, tf = _flat(jout, JTensor), _flat(tout, torch.Tensor)
    assert len(jf) == len(tf), (op, len(jf), len(tf))
    if not jf:
        assert jout == tout, (op, jout, tout)
    for i, (a, b) in enumerate(zip(jf, tf)):
        assert dtype_name(b.dtype) == dtype_name(str(a.dtype)), \
            (op, i, str(a.dtype), b.dtype)
        if op in LAW:
            assert tuple(b.shape) == tuple(a.shape), (op, i)
            continue
        _close(op, f"output {i}", b.numpy(), _j_np(a), tol)


def _spectral(op, jout, tout, a):
    """eig/eigvals/eigh/svd/qr-like results by their defining identities
    and the reference's values up to order and sign."""
    if op in ("eigvals",):
        _close(op, "values", np.sort_complex(tout.numpy()),
               np.sort_complex(_j_np(jout)))
        return
    if op == "eig":
        w, v = tout[0].numpy(), tout[1].numpy()
        _close(op, "values", np.sort_complex(w), np.sort_complex(
            _j_np(jout[0])))
        _close(op, "A v = v w", a.astype(np.complex64) @ v, v * w[None, :])
        return
    raise AssertionError(op)


def _float_idx(args):
    return [i for i, x in enumerate(args) if isinstance(x, JTensor)
            and np.issubdtype(np.asarray(x._value).dtype, np.floating)]


def _ref_grad(fn, args, kwargs, idx):
    for i in idx:
        args[i].stop_gradient = False
    out = fn(*args, **kwargs)
    outs = [o for o in _flat(out, JTensor)
            if np.issubdtype(np.asarray(o._value).dtype, np.floating)]
    if not outs:
        return None
    loss = outs[0].astype("float32").sum()
    for o in outs[1:]:
        loss = loss + o.astype("float32").sum()
    loss.backward()
    return [None if args[i].grad is None else _j_np(args[i].grad)
            for i in idx]


def _port_grad(fn, args, kwargs, idx):
    for i in idx:
        args[i].stop_gradient = False
    out = fn(*args, **kwargs)
    outs = [o for o in _flat(out, torch.Tensor) if o.is_floating_point()]
    if not outs:
        return None
    loss = outs[0].astype("float32").sum()
    for o in outs[1:]:
        loss = loss + o.astype("float32").sum()
    loss.backward()
    return [None if args[i].grad is None else args[i].grad.numpy()
            for i in idx]


def _signs(op, jout, tout):
    """Per vector, the sign that turns the port's into the reference's."""
    k = SIGNED[op][0]
    dots = np.sum(_j_np(jout[k]) * tout[k].detach().numpy(), axis=-2)
    return torch.from_numpy(np.where(dots < 0, -1.0, 1.0).astype(
        np.float32))


def _signed(op, out, s):
    k, k2, axis = SIGNED[op]
    out = list(out)
    out[k] = out[k] * s
    if k2 is not None:
        out[k2] = out[k2] * (s[:, None] if axis == -2 else s)
    return tuple(out)


def _port_fn(op, fn):
    if op == "linear":
        # the port's linear takes torch's [out, in] weight; the
        # reference's is [in, out]
        return lambda x, w, b=None, name=None: fn(x, w.mT, b)
    return fn


def run_case(op):
    jfn = jresolve(_JSPECS[op])
    tfn = _port_fn(op, getattr(pt._C_ops, op))
    jargs, jkw = _build(op)
    targs, tkw = _port(jargs), _port(jkw)
    paddle.seed(1234)
    pt.seed(1234)
    jout = jfn(*jargs, **jkw)
    tout = tfn(*targs, **tkw)
    if op in SIGNED:
        s = _signs(op, jout, tout)
        raw = tfn
        tfn = lambda *a, **k: _signed(op, raw(*a, **k), s)  # noqa: E731
        tout = _signed(op, tout, s)
    if op in ("eig", "eigvals"):
        _spectral(op, jout, tout, np.asarray(jargs[0]._value))
    else:
        _compare_outputs(op, jout, tout,
                         tol=1e-5 if op not in ULPS else 1e-5)
    if op in BITS or op in ULPS or op in LAW or op in NO_GRAD:
        return
    jargs, jkw = _build(op)
    idx = _float_idx(jargs)
    if not idx:
        return
    targs, tkw = _port(jargs), _port(jkw)
    paddle.seed(1234)
    pt.seed(1234)
    jg = _ref_grad(jfn, jargs, jkw, idx)
    tg = _port_grad(tfn, targs, tkw, idx)
    if jg is None:
        assert tg is None, op
        return
    for k, (a, b) in enumerate(zip(jg, tg)):
        if a is None or b is None:
            # no gradient on one side: the other's is zero
            assert not np.any(a if b is None else b), (op, k)
            continue
        _close(op, f"grad {k}", b, a, floor=1.0)


@pytest.mark.parametrize("op_name", ALL[0::3])
def test_op_sweep_port(op_name):
    run_case(op_name)
