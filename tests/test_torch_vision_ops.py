"""The port's ``vision.ops`` held against the JAX package's on the CPU, on
the same numpy inputs: ``roi_align`` and ``roi_pool`` (boxes off the
map, both ``aligned`` forms, ``sampling_ratio``, ``spatial_scale``, and
``boxes_num`` summing short of and past the RoI count), ``deform_conv2d``
(v1 and v2, stride, padding, dilation, offsets reaching off the padded
map), ``box_coder`` (encode, decode, both normalizations),
``prior_box``, ``nms`` (category-aware, ``top_k``) and ``matrix_nms``
(linear and Gaussian decay).

Tolerances (float32): values and input gradients within ``1e-5`` of the
reference's largest entry (``max(1, |ref|)``); gradients come from
``jax.vjp`` of the reference's op and torch autograd with one random
cotangent.  The host ops' outputs are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.vision import ops as jops
from paddle_tpu_torch.vision import ops as tops

REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rand(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def _close(got, want, rel=REL, what=""):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rel * max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol, (what, err, tol)


def _both(jfn, tfn, inputs, diff=(0,), seed=7):
    def jf(*arrs):
        full = list(map(jnp.asarray, inputs))
        for i, a in zip(diff, arrs):
            full[i] = a
        return jfn(*[JTensor(a) for a in full])._value

    want, vjp = jax.vjp(jf, *[jnp.asarray(inputs[i]) for i in diff])
    g = _rand(np.shape(want), seed)
    wgrads = vjp(jnp.asarray(g, dtype=want.dtype))
    tin = [torch.tensor(np.array(a, copy=True)) for a in inputs]
    for i in diff:
        tin[i].requires_grad_(True)
    got = tfn(*tin)
    _close(got.detach().numpy(), want, what="value")
    (got * torch.from_numpy(g)).sum().backward()
    for i, wg in zip(diff, wgrads):
        _close(tin[i].grad.numpy(), wg, what=f"grad {i}")
    return got


BOXES = np.array([[1.0, 2.0, 7.5, 8.0], [-3.0, -2.0, 4.0, 5.0],
                  [6.0, 1.0, 14.0, 12.5], [0.5, 0.5, 1.5, 2.0],
                  [9.0, 7.0, 30.0, 20.0]], np.float32)


@pytest.mark.parametrize("op", ["roi_align", "roi_pool"])
@pytest.mark.parametrize("boxes_num", [[2, 3], [2, 1], [4, 4], [0, 5]])
def test_roi_ops_match_jax(op, boxes_num):
    x = _rand((2, 3, 10, 12), 1)
    bn = np.asarray(boxes_num, np.int32)
    cases = [dict(output_size=3)]
    if op == "roi_align":
        cases += [dict(output_size=(2, 4), spatial_scale=0.5,
                       sampling_ratio=3),
                  dict(output_size=2, aligned=False, sampling_ratio=1)]
    else:
        cases += [dict(output_size=(2, 4), spatial_scale=0.5)]
    for kw in cases:
        out = _both(lambda a, b, n: getattr(jops, op)(a, b, n, **kw),
                    lambda a, b, n: getattr(tops, op)(a, b, n, **kw),
                    [x, BOXES, bn])
        assert out.shape[0] == len(BOXES)


def test_roi_layers():
    x = torch.tensor(_rand((1, 2, 8, 8), 2))
    b = torch.tensor(BOXES[:2])
    n = torch.tensor([2])
    assert torch.equal(tops.RoIAlign(2)(x, b, n), tops.roi_align(x, b, n, 2))
    assert torch.equal(tops.RoIPool(2, 0.5)(x, b, n),
                       tops.roi_pool(x, b, n, 2, 0.5))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("geom", [dict(), dict(stride=2, padding=1),
                                  dict(padding=(2, 1), dilation=2)])
def test_deform_conv2d_matches_jax(masked, geom):
    n, c, h, w, o, k = 2, 3, 7, 8, 4, 3
    s = geom.get("stride", 1)
    p = geom.get("padding", 0)
    p = (p, p) if isinstance(p, int) else p
    d = geom.get("dilation", 1)
    ho = (h + 2 * p[0] - d * (k - 1) - 1) // s + 1
    wo = (w + 2 * p[1] - d * (k - 1) - 1) // s + 1
    x = _rand((n, c, h, w), 3)
    off = _rand((n, 2 * k * k, ho, wo), 4, scale=2.5)   # some off the map
    wt = _rand((o, c, k, k), 5, scale=0.3)
    bias = _rand((o,), 6)
    inputs = [x, off, wt, bias]
    if masked:
        inputs.append(np.random.default_rng(8).random(
            (n, k * k, ho, wo)).astype(np.float32))

    def call(mod):
        def f(a, of, w_, b, *m):
            return mod.deform_conv2d(a, of, w_, b, mask=m[0] if m else None,
                                     **geom)
        return f

    _both(call(jops), call(tops), inputs, diff=tuple(range(len(inputs))))


def test_deform_conv2d_layer_and_refusal():
    layer = tops.DeformConv2D(3, 4, 3, padding=1, device="cpu", seed=1)
    assert layer.weight.shape == (4, 3, 3, 3)
    assert torch.equal(layer.bias, torch.zeros(4))
    x = torch.tensor(_rand((1, 3, 5, 5), 9))
    off = torch.zeros(1, 18, 5, 5)
    want = torch.nn.functional.conv2d(x, layer.weight, layer.bias,
                                      padding=1)
    torch.testing.assert_close(layer(x, off), want, atol=1e-5, rtol=1e-5)
    with pytest.raises(NotImplementedError, match="groups"):
        tops.deform_conv2d(x, off, layer.weight, groups=3)


@pytest.mark.parametrize("normalized", [True, False])
def test_box_coder_matches_jax(normalized):
    rng = np.random.default_rng(10)
    pb = np.sort(rng.random((6, 4)).astype(np.float32) * 10, axis=1)
    pb = pb[:, [0, 1, 2, 3]]
    pb[:, 2:] += 1.0
    var = np.tile(np.array([[0.1, 0.1, 0.2, 0.2]], np.float32), (6, 1))
    tb = pb + rng.random((6, 4)).astype(np.float32)
    tb[:, 2:] += 1.0
    enc = _both(lambda a, v, t: jops.box_coder(a, v, t,
                                                box_normalized=normalized),
                lambda a, v, t: tops.box_coder(a, v, t,
                                               box_normalized=normalized),
                [pb, var, tb], diff=(2,))
    _both(lambda a, v, t: jops.box_coder(a, v, t, "decode_center_size",
                                         box_normalized=normalized),
          lambda a, v, t: tops.box_coder(a, v, t, "decode_center_size",
                                         box_normalized=normalized),
          [pb, var, enc.detach().numpy()], diff=(2,))


@pytest.mark.parametrize("kw", [
    dict(min_sizes=[4.0]),
    dict(min_sizes=[3.0, 6.0], max_sizes=[5.0, 9.0],
         aspect_ratios=(1.0, 2.0), flip=True, clip=True),
    dict(min_sizes=[2.0], steps=(4.0, 3.0), offset=0.25)])
def test_prior_box_matches_jax(kw):
    feat = np.zeros((1, 8, 3, 5), np.float32)
    image = np.zeros((1, 3, 24, 30), np.float32)
    wb, wv = jops.prior_box(JTensor(jnp.asarray(feat)),
                            JTensor(jnp.asarray(image)), **kw)
    gb, gv = tops.prior_box(torch.tensor(feat), torch.tensor(image), **kw)
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb._value))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv._value))


def _boxes(n, seed):
    rng = np.random.default_rng(seed)
    xy = rng.random((n, 2)).astype(np.float32) * 20
    wh = rng.random((n, 2)).astype(np.float32) * 8 + 1
    return np.concatenate([xy, xy + wh], 1), rng.random(n).astype(
        np.float32)


@pytest.mark.parametrize("kw", [dict(), dict(iou_threshold=0.1),
                                dict(top_k=3), dict(category=True),
                                dict(no_scores=True)])
def test_nms_matches_jax(kw):
    b, s = _boxes(24, 11)
    args = dict(iou_threshold=kw.get("iou_threshold", 0.3),
                top_k=kw.get("top_k"))
    cats = np.random.default_rng(12).integers(0, 3, 24)
    jargs, targs = dict(args), dict(args)
    if not kw.get("no_scores"):
        jargs["scores"] = JTensor(jnp.asarray(s))
        targs["scores"] = torch.tensor(s)
    if kw.get("category"):
        jargs["category_idxs"] = JTensor(jnp.asarray(cats))
        targs["category_idxs"] = torch.tensor(cats)
    want = np.asarray(jops.nms(JTensor(jnp.asarray(b)), **jargs)._value)
    got = tops.nms(torch.tensor(b), **targs)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw", [
    dict(score_threshold=0.2), dict(score_threshold=0.1, nms_top_k=8,
                                    keep_top_k=5, post_threshold=0.05),
    dict(score_threshold=0.0, use_gaussian=True, gaussian_sigma=0.5),
    dict(score_threshold=2.0)])
def test_matrix_nms_matches_jax(kw):
    b, s = _boxes(20, 13)
    ws, wi = jops.matrix_nms(JTensor(jnp.asarray(b)),
                             JTensor(jnp.asarray(s)), **kw)
    gs, gi = tops.matrix_nms(torch.tensor(b), torch.tensor(s), **kw)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws._value))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi._value))
    assert gs.dtype == torch.float32 and gi.dtype == torch.int64
