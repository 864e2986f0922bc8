"""The port's ``cross_entropy``, ``softmax_with_cross_entropy`` and
``nll_loss`` held against the JAX package's on the CPU, option by
option, on the same numpy inputs.

Tolerance: ``atol 1e-6`` on values and ``atol 1e-6`` on the logits'
gradients (float32; log-softmax and the sums in other orders).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.nn import functional as tF

ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _hard(shape, classes, seed, n_ignored=2, axis=-1):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal(shape).astype(np.float32)
    lshape = list(shape)
    del lshape[axis % len(shape)]
    labels = rng.integers(0, classes, lshape).astype(np.int64)
    flat = labels.reshape(-1)
    flat[rng.permutation(flat.size)[:n_ignored]] = -100
    return logits, labels


def _compare(jfn, tfn, logits, *rest, grad=True):
    """Values (and the logits' gradient of the sum) of both sides."""
    def jf(x):
        return jnp.sum(jfn(JTensor(x), *[JTensor(jnp.asarray(r))
                                         for r in rest])._value)
    want, wgrad = jax.value_and_grad(jf)(jnp.asarray(logits))
    tx = torch.tensor(logits, requires_grad=True)
    got = tfn(tx, *[torch.from_numpy(np.array(r, copy=True))
                    for r in rest]).sum()
    np.testing.assert_allclose(float(got.detach()), float(want), atol=ATOL,
                               rtol=1e-6)
    if grad:
        got.backward()
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(wgrad),
                                   atol=ATOL, rtol=0)


HARD = list(itertools.product(["mean", "sum", "none"], [False, True],
                              [False, True]))


@pytest.mark.parametrize("reduction,weighted,trailing", HARD)
def test_hard_labels(reduction, weighted, trailing):
    logits, labels = _hard((3, 4, 7), 7, seed=len(reduction) + 2 * weighted)
    if trailing:
        labels = labels[..., None]
    rest = [labels]
    kw = dict(reduction=reduction, ignore_index=-100)
    if weighted:
        rest.append(np.random.default_rng(1).random(7).astype(np.float32)
                    + 0.5)

    def jfn(x, lab, *w):
        return JF.cross_entropy(x, lab, *w, **kw) if not w else \
            JF.cross_entropy(x, lab, weight=w[0], **kw)

    def tfn(x, lab, *w):
        return tF.cross_entropy(x, lab, *w, **kw) if not w else \
            tF.cross_entropy(x, lab, weight=w[0], **kw)

    _compare(jfn, tfn, logits, *rest)
    if reduction == "none":
        got = tfn(torch.from_numpy(logits), *[torch.from_numpy(r)
                                              for r in rest])
        assert got.shape == ((3, 4, 1) if trailing else (3, 4))


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("explicit", [True, False])
def test_soft_labels(reduction, smoothing, explicit):
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((5, 6)).astype(np.float32)
    soft = rng.random((5, 6)).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    kw = dict(reduction=reduction, label_smoothing=smoothing,
              soft_label=explicit)
    _compare(lambda x, lab: JF.cross_entropy(x, lab, **kw),
             lambda x, lab: tF.cross_entropy(x, lab, **kw), logits, soft)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_label_smoothing_hard_labels(reduction):
    logits, labels = _hard((6, 9), 9, seed=11)
    kw = dict(reduction=reduction, label_smoothing=0.2)
    _compare(lambda x, lab: JF.cross_entropy(x, lab, **kw),
             lambda x, lab: tF.cross_entropy(x, lab, **kw), logits, labels)


@pytest.mark.parametrize("soft", [False, True])
def test_class_axis_one(soft):
    rng = np.random.default_rng(12)
    logits = rng.standard_normal((2, 5, 3)).astype(np.float32)
    if soft:
        lab = rng.random((2, 5, 3)).astype(np.float32)
        lab /= lab.sum(1, keepdims=True)
    else:
        lab = rng.integers(0, 5, (2, 3)).astype(np.int64)
    kw = dict(axis=1, reduction="none", soft_label=soft)
    _compare(lambda x, l_: JF.cross_entropy(x, l_, **kw),
             lambda x, l_: tF.cross_entropy(x, l_, **kw), logits, lab)


def test_use_softmax_false():
    logits, labels = _hard((4, 6), 6, seed=13)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    probs[0, 0] = 0.0           # log(max(p, 1e-30))
    kw = dict(use_softmax=False, reduction="sum")
    _compare(lambda x, lab: JF.cross_entropy(x, lab, **kw),
             lambda x, lab: tF.cross_entropy(x, lab, **kw), probs, labels)


def test_weighted_mean_of_all_ignored_is_zero():
    logits = np.zeros((3, 4), np.float32)
    labels = np.full((3,), -100, np.int64)
    w = np.ones(4, np.float32)
    want = JF.cross_entropy(JTensor(jnp.asarray(logits)),
                            JTensor(jnp.asarray(labels)),
                            weight=JTensor(jnp.asarray(w)))
    got = tF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                           weight=torch.from_numpy(w))
    assert float(got) == float(want._value) == 0.0


@pytest.mark.parametrize("return_softmax", [False, True])
@pytest.mark.parametrize("soft", [False, True])
def test_softmax_with_cross_entropy(return_softmax, soft):
    logits, labels = _hard((4, 6), 6, seed=21)
    if soft:
        labels = np.random.default_rng(2).random((4, 6)).astype(np.float32)
        labels /= labels.sum(-1, keepdims=True)
    kw = dict(soft_label=soft, return_softmax=return_softmax)
    want = JF.softmax_with_cross_entropy(JTensor(jnp.asarray(logits)),
                                         JTensor(jnp.asarray(labels)), **kw)
    got = tF.softmax_with_cross_entropy(torch.from_numpy(logits),
                                        torch.from_numpy(labels), **kw)
    want = want if return_softmax else (want,)
    got = got if return_softmax else (got,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w._value),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("weighted", [False, True])
def test_nll_loss(reduction, weighted):
    logits, labels = _hard((5, 4), 4, seed=31)
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    rest = [labels]
    if weighted:
        rest.append(np.array([0.5, 1.0, 2.0, 1.5], np.float32))

    def jfn(x, lab, *w):
        return JF.nll_loss(x, lab, weight=w[0] if w else None,
                           reduction=reduction)

    def tfn(x, lab, *w):
        return tF.nll_loss(x, lab, weight=w[0] if w else None,
                           reduction=reduction)

    _compare(jfn, tfn, logp.astype(np.float32), *rest)
