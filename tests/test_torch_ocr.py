"""The port's PP-OCR models held against the JAX package's on the CPU, on
the JAX models' weights and buffers carried by the weight bridge
(``ocr_state_from_jax``): DBNet's training maps (probability, threshold,
binary) and eval map, ``DBLoss`` and its gradient, ``db_postprocess``;
CRNN's logits, ``CTCHeadLoss`` and its gradient, three ``TrainStep``
calls of CRNN + CTC with Adam against the JAX ``TrainStep``;
``ctc_greedy_decode`` and the ``PPOCRSystem`` facade.

Tolerances (float32): maps, logits and losses within ``1e-5`` of their
largest entry (``max(1, |ref|)``), DBNet's binary map ``2e-4`` (it is
``sigmoid(50 (P - T))``, whose slope reaches 12.5: measured 1.6e-5);
batch-norm buffers ``atol 1e-5, rtol 1e-5``; the Adam steps: the first
loss ``rtol 1e-5``, the later ones ``rtol 1e-4`` (measured 3.6e-5), and
every parameter within ``2 * lr * steps`` plus ``1e-5`` with at most 5%
of its elements past ``1e-4`` (Adam's step is ``lr * m / (sqrt(v) +
eps)``, a function of the gradient's sign and relative size: an element
whose gradient is small against its float32 noise moves by up to ``lr``
a step on either side, as ``test_torch_ernie.py`` holds its key bias;
measured: up to 2.7% of a convolution's elements past ``1e-4``, the
largest 9.4e-3); the running buffers after those steps ``atol 2e-3,
rtol 1e-3`` (the last step's forward reads those parameters: measured
4.5e-4); the boxes and decoded strings are equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.jit.train_step import TrainStep as JTrainStep
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import ocr_state_from_jax
from paddle_tpu_torch.optimizer import Adam

REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, rel=REL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


def _arrays(jnet):
    out = {n: np.asarray(p._value) for n, p in jnet.named_parameters()}
    out.update({n: np.asarray(b._value) for n, b in jnet.named_buffers()})
    return out


def _bridge(jnet, tnet):
    tnet.load_state_dict(ocr_state_from_jax(_arrays(jnet), tnet),
                         strict=True)
    return jnet, tnet


def _buffers_close(jnet, tnet):
    jb = dict(jnet.named_buffers())
    for name, b in tnet.named_buffers():
        np.testing.assert_allclose(b.numpy(), np.asarray(jb[name]._value),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


DET = dict(backbone_scale=0.25, fpn_channels=32)
REC = dict(num_classes=12, hidden_size=16)


@pytest.fixture(scope="module")
def dbnets():
    paddle.seed(0)
    jnet = jmodels.DBNet(jmodels.DBNetConfig(**DET))
    tnet = tmodels.DBNet(tmodels.DBNetConfig(**DET), device="cpu")
    return _bridge(jnet, tnet)


@pytest.fixture(scope="module")
def crnns():
    paddle.seed(1)
    jnet = jmodels.CRNN(jmodels.CRNNConfig(**REC))
    tnet = tmodels.CRNN(tmodels.CRNNConfig(**REC), device="cpu")
    return _bridge(jnet, tnet)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_dbnet_maps(dbnets, mode):
    jnet, tnet = dbnets
    getattr(jnet, mode)()
    getattr(tnet, mode)()
    x = _rand((2, 3, 64, 64), 2)
    want = np.asarray(jnet(paddle.to_tensor(x))["maps"]._value)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x))["maps"]
    assert tuple(got.shape) == ((2, 3, 64, 64) if mode == "train"
                                else (2, 1, 64, 64))
    _close(got[:, :2].numpy(), want[:, :2], what=mode)
    if mode == "train":                    # the binary map, slope k / 4
        _close(got[:, 2:].numpy(), want[:, 2:], 2e-4, what="binary")
    _buffers_close(jnet, tnet)


def test_db_loss_and_gradient():
    rng = np.random.default_rng(3)
    maps = (1 / (1 + np.exp(-rng.standard_normal((2, 3, 16, 16))))) \
        .astype(np.float32)
    gt = np.zeros((2, 1, 16, 16), np.float32)
    gt[:, :, 4:12, 3:10] = 1.0
    gt_t = gt * 0.5

    def jf(m):
        return jmodels.DBLoss()({"maps": JTensor(m)}, JTensor(jnp.asarray(gt)),
                                JTensor(jnp.asarray(gt_t)))._value

    want, grad = jax.value_and_grad(jf)(jnp.asarray(maps))
    tm = torch.tensor(maps, requires_grad=True)
    got = tmodels.DBLoss()({"maps": tm}, torch.from_numpy(gt),
                           torch.from_numpy(gt_t))
    got.backward()
    _close(float(got), float(want))
    _close(tm.grad.numpy(), np.asarray(grad))
    no_t = tmodels.DBLoss()({"maps": tm}, torch.from_numpy(gt))
    want_no_t = jmodels.DBLoss()({"maps": JTensor(jnp.asarray(maps))},
                                 JTensor(jnp.asarray(gt)))._value
    _close(float(no_t), float(want_no_t))


def test_db_postprocess_matches_the_reference():
    rng = np.random.default_rng(4)
    pm = np.zeros((2, 1, 40, 48), np.float32)
    pm[0, 0, 10:20, 5:25] = 0.9
    pm[0, 0, 25:28, 30:45] = 0.7           # thin box
    pm[0, 0, 2:4, 2:3] = 0.95              # below min_size
    pm[1] = rng.uniform(0, 1, (1, 40, 48)).astype(np.float32)
    want = jmodels.db_postprocess(paddle.to_tensor(pm))
    for got in (tmodels.db_postprocess(torch.from_numpy(pm)),
                tmodels.db_postprocess(pm)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert tuple(want[0][0][:4]) == (5, 10, 25, 20)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_crnn_logits_and_ctc_head(crnns, mode):
    jnet, tnet = crnns
    getattr(jnet, mode)()
    getattr(tnet, mode)()
    x = _rand((2, 3, 32, 64), 5)
    want = np.asarray(jnet(paddle.to_tensor(x))._value)
    got = tnet(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 16, 12)
    _close(got.detach().numpy(), want, what="logits")
    labels = np.array([[3, 3, 5, 1], [2, 7, 0, 0]], np.int64)
    lens = np.array([4, 2], np.int64)

    def jf(lg):
        return jmodels.CTCHeadLoss()(JTensor(lg), JTensor(jnp.asarray(
            labels)), JTensor(jnp.asarray(lens)))._value

    wl, wg = jax.value_and_grad(jf)(jnp.asarray(want))
    lg = torch.tensor(want, requires_grad=True)
    tl = tmodels.CTCHeadLoss()(lg, torch.from_numpy(labels),
                               torch.from_numpy(lens))
    tl.backward()
    _close(float(tl), float(wl))
    _close(lg.grad.numpy(), np.asarray(wg))


def test_crnn_train_steps_match_jax():
    lr, steps = 5e-3, 3
    paddle.seed(6)
    jnet = jmodels.CRNN(jmodels.CRNNConfig(**REC))
    tnet = tmodels.CRNN(tmodels.CRNNConfig(**REC), device="cpu")
    _bridge(jnet, tnet)
    jnet.train()
    tnet.train()
    jcrit, tcrit = jmodels.CTCHeadLoss(), tmodels.CTCHeadLoss()
    jstep = JTrainStep(jnet, lambda n, x, y, ln: jcrit(n(x), y, ln),
                       paddle.optimizer.Adam(learning_rate=lr,
                                             parameters=jnet.parameters()))
    tstep = TrainStep(tnet, lambda n, x, y, ln: tcrit(n(x), y, ln),
                      Adam(learning_rate=lr, parameters=tnet.parameters()))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 3, 32, 64)).astype(np.float32)
    labels = rng.integers(1, 12, (2, 4)).astype(np.int64)
    lens = np.array([4, 3], np.int64)
    jl, tl = [], []
    for _ in range(steps):
        jl.append(float(jstep(paddle.to_tensor(x), paddle.to_tensor(labels),
                              paddle.to_tensor(lens))))
        tl.append(float(tstep(x, labels, lens)))
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-5, atol=0)
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=0)
    assert tl[-1] < tl[0]
    tparams = dict(tnet.named_parameters())
    for name, p in jnet.named_parameters():
        want = np.asarray(p._value)
        if name == "fc.weight":                 # the one Linear weight
            want = want.T
        np.testing.assert_allclose(tparams[name].detach().numpy(), want,
                                   atol=2 * lr * steps + 1e-5, rtol=0,
                                   err_msg=name)
        diff = np.abs(tparams[name].detach().numpy() - want)
        assert (diff > 1e-4).mean() <= 0.05, name
    jb = dict(jnet.named_buffers())
    for name, b in tnet.named_buffers():
        np.testing.assert_allclose(b.numpy(), np.asarray(jb[name]._value),
                                   atol=2e-3, rtol=1e-3, err_msg=name)


def test_ctc_greedy_decode():
    logits = np.full((2, 6, 8), -5.0, np.float32)
    for b, seq in enumerate(([0, 3, 3, 0, 5, 5], [2, 0, 2, 2, 7, 0])):
        for t, c in enumerate(seq):
            logits[b, t, c] = 5.0
    want = jmodels.ctc_greedy_decode(paddle.to_tensor(logits))
    assert tmodels.ctc_greedy_decode(torch.from_numpy(logits)) == want
    assert want == [[3, 5], [2, 2, 7]]


def test_ppocr_system_facade():
    det = tmodels.DBNet(tmodels.DBNetConfig(**DET), device="cpu", seed=2)
    rec = tmodels.CRNN(tmodels.CRNNConfig(num_classes=10, hidden_size=16),
                       device="cpu", seed=3)
    w = det.backbone.stem.conv.weight.detach().clone()
    sys_ = tmodels.PPOCRSystem(det, rec)
    assert torch.equal(sys_.det.backbone.stem.conv.weight, w)
    sys_.eval()
    with torch.no_grad():
        out = sys_(torch.zeros(1, 3, 32, 32))
        assert tuple(out["maps"].shape) == (1, 1, 32, 32)
        rec_out = sys_.recognize_crops(torch.zeros(2, 3, 32, 48))
    assert rec_out.shape[0] == 2 and rec_out.shape[2] == 10
    full = tmodels.PPOCRSystem(device="cpu")
    assert next(full.parameters()).device.type == "cpu"
