"""The port's hapi surface held against the JAX package's on the CPU:
``Model.fit``/``evaluate`` on bridged weights (``vision_state_from_jax``)
without shuffling, per epoch, with the train-batch ``Accuracy``; AMP O1
(compiled and eager with its ``GradScaler``) and O2's ``TypeError``;
``EarlyStopping`` (which fires in neither package); ``save``/``load`` in
place; ``summary`` rows and ``flops`` totals; the callbacks' log lines;
and one CPU run of the example twin.

Tolerances (float32; convolutions sum in other orders): LeNet's
per-epoch losses and accuracies within ``1e-5`` of the reference's
(``max(1, |ref|)``).  ResNet-18 at B=8 on 32x32 images normalizes 8 x 1
x 1 values a channel in its last stage, where small-batch batch norm
amplifies float32 order differences (``tests/test_torch_vision_models.py``
holds each package within 1e-3 of a float64 run there).
Measured on these inputs, after one Adam step the second batch's loss
is 2.0e-4 (the reference) and 9.6e-4 (the port) from a float64 run of
the port, 1.16e-3 apart; the first batch's agree to 2e-7.  So its
losses are held within ``2e-3`` relative (1e-3 a package), its
accuracies exactly.  O1
casts convolutions and matmuls to bf16 in both packages, so the loss is
a bf16 value: measured equal, held within one bf16 ulp (``2**-7``
relative), the accuracies exactly.
"""

import contextlib
import io as _io
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.hapi.callbacks import Callback as JCallback
from paddle_tpu.vision import datasets as jds
from paddle_tpu.vision import models as jm
import paddle_tpu_torch as paddle
from paddle_tpu_torch.hapi.callbacks import Callback as TCallback
from paddle_tpu_torch.models import vision_state_from_jax
from paddle_tpu_torch.vision import datasets as tds
from paddle_tpu_torch.vision import models as tm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _arrays(jnet):
    out = {n: np.asarray(p._value) for n, p in jnet.named_parameters()}
    out.update({n: np.asarray(b._value) for n, b in jnet.named_buffers()})
    return out


def _pair(name, seed=0, **kw):
    jpaddle.seed(seed)
    jnet = getattr(jm, name)(**kw)
    tnet = getattr(tm, name)(device="cpu", **kw)
    tnet.load_state_dict(vision_state_from_jax(_arrays(jnet), tnet))
    return jnet, tnet


def _recorder(base):
    class Rec(base):
        def __init__(self):
            super().__init__()
            self.epochs = []
            self.batches = []

        def on_train_batch_end(self, step, logs=None):
            self.batches.append(dict(logs))

        def on_epoch_end(self, epoch, logs=None):
            self.epochs.append(dict(logs))

    return Rec()


def _fit(pkg, net, train, evald=None, epochs=2, batch_size=8, amp=None,
         jit=True, callbacks=(), lr=1e-3, **kw):
    rec = _recorder(JCallback if pkg is jpaddle else TCallback)
    opt = pkg.optimizer.Adam(learning_rate=lr, parameters=net.parameters())
    model = pkg.Model(net)
    model.prepare(optimizer=opt, loss=pkg.nn.CrossEntropyLoss(),
                  metrics=pkg.metric.Accuracy(), jit=jit, amp_configs=amp)
    model.fit(train, eval_data=evald, epochs=epochs, batch_size=batch_size,
              shuffle=False, verbose=0, callbacks=[rec, *callbacks], **kw)
    return model, rec


def _close_logs(got, want, rel, what, acc_exact=False):
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w), (what, g, w)
        for k in w:
            gv, wv = float(np.asarray(g[k])), float(np.asarray(w[k]))
            if acc_exact and "acc" in k:
                assert gv == wv, (what, k, gv, wv)
            else:
                assert abs(gv - wv) <= rel * max(1.0, abs(wv)), \
                    (what, k, gv, wv)


@pytest.fixture(scope="module")
def lenet_runs():
    """Two epochs of LeNet on ``MNIST(size=32)`` at B=8 with eval on
    ``MNIST(mode="test", size=16)``, in each package from one state."""
    jnet, tnet = _pair("LeNet")
    kw = dict(size=32)
    jm_, jrec = _fit(jpaddle, jnet, jds.MNIST(**kw),
                     jds.MNIST(mode="test", size=16))
    tm_, trec = _fit(paddle, tnet, tds.MNIST(**kw),
                     tds.MNIST(mode="test", size=16))
    return jm_, jrec, tm_, trec


def test_lenet_fit_matches_jax(lenet_runs):
    jm_, jrec, tm_, trec = lenet_runs
    assert len(trec.epochs) == 2 and len(trec.batches) == 8
    assert set(trec.epochs[0]) == {"loss", "acc", "eval_loss", "eval_acc"}
    _close_logs(trec.epochs, jrec.epochs, 1e-5, "epochs")
    _close_logs(trec.batches, jrec.batches, 1e-5, "batches")
    acc = trec.epochs[-1]["acc"]
    assert type(acc) is type(jrec.epochs[-1]["acc"]) is np.float64
    assert trec.epochs[-1]["loss"] != trec.epochs[0]["loss"]


def test_lenet_evaluate_and_predict_match_jax(lenet_runs):
    jm_, _, tm_, _ = lenet_runs
    want = jm_.evaluate(jds.MNIST(mode="test", size=16), batch_size=4)
    got = tm_.evaluate(tds.MNIST(mode="test", size=16), batch_size=4)
    _close_logs([got], [want], 1e-5, "evaluate")
    x = np.random.default_rng(4).standard_normal(
        (8, 1, 28, 28)).astype(np.float32)
    jp = jm_.predict(jpaddle.io.TensorDataset([jpaddle.to_tensor(x)]),
                     batch_size=4)
    tp = tm_.predict(paddle.io.TensorDataset([torch.tensor(x)]),
                     batch_size=4)
    assert len(tp) == len(jp) == 2
    for g, w in zip(tp, jp):
        g = g[0] if isinstance(g, (list, tuple)) else g
        w = w[0] if isinstance(w, (list, tuple)) else w
        np.testing.assert_allclose(g.numpy(), np.asarray(w._value),
                                   atol=1e-5 * max(1.0, float(np.abs(
                                       np.asarray(w._value)).max())))


def test_resnet18_fit_matches_jax():
    jnet, tnet = _pair("resnet18", num_classes=10)
    _, jrec = _fit(jpaddle, jnet, jds.Cifar10(size=16), epochs=1)
    _, trec = _fit(paddle, tnet, tds.Cifar10(size=16), epochs=1)
    assert len(trec.batches) == 2
    _close_logs(trec.batches, jrec.batches, 2e-3, "resnet18",
                acc_exact=True)


@pytest.mark.parametrize("jit", [True, False])
def test_lenet_amp_o1_matches_jax(jit):
    """O1 (bf16 convolutions and matmuls) compiled, and eager with the
    ``GradScaler`` (``jit=False``), as the reference's."""
    jnet, tnet = _pair("LeNet", seed=3)
    _, jrec = _fit(jpaddle, jnet, jds.MNIST(size=16), epochs=1, amp="O1",
                   jit=jit)
    tmodel, trec = _fit(paddle, tnet, tds.MNIST(size=16), epochs=1,
                        amp="O1", jit=jit)
    assert (tmodel._scaler is None) == jit
    _close_logs(trec.batches, jrec.batches, 2.0 ** -7, f"O1 jit={jit}",
                acc_exact=True)


def test_amp_o2_raises_type_error_in_both():
    """O2 casts the network to bf16 and leaves the float32 batch as it
    is: the first convolution refuses the mixed dtypes in both packages
    (a reference finding, ROADMAP.md)."""
    jnet, tnet = _pair("LeNet")
    with pytest.raises(TypeError, match="same dtypes"):
        _fit(jpaddle, jnet, jds.MNIST(size=8), epochs=1, amp="O2")
    with pytest.raises(TypeError, match="same dtypes"):
        _fit(paddle, tnet, tds.MNIST(size=8), epochs=1, amp="O2")
    assert tnet.features[0].weight.dtype == torch.bfloat16


def test_early_stopping_never_fires_in_either():
    """``EarlyStopping`` acts in ``on_eval_end``, which neither package's
    ``fit`` calls: with patience 0 and eval data every epoch trains."""
    runs = {}
    for pkg, ds, cb in ((jpaddle, jds, jpaddle.hapi.callbacks),
                        (paddle, tds, paddle.hapi.callbacks)):
        jnet, tnet = _pair("LeNet")
        net = jnet if pkg is jpaddle else tnet
        stop = cb.EarlyStopping(monitor="loss", patience=0)
        model, rec = _fit(pkg, net, ds.MNIST(size=8),
                          ds.MNIST(mode="test", size=8), epochs=3,
                          callbacks=[stop])
        runs[pkg.__name__] = (len(rec.epochs), stop.stopped,
                              model.stop_training)
    assert runs["paddle_tpu"] == runs["paddle_tpu_torch"] == (3, False,
                                                              False)


def test_train_batch_metrics_and_progress_log(capsys):
    """``train_batch`` returns ``([loss], [acc])`` with metrics, and the
    ``ProgBarLogger`` prints samples/s and the ETA (the reference's
    ``test_model_train_metrics_and_progress``)."""
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.standard_normal((32, 8)).astype(np.float32))
    ys = torch.from_numpy(rng.integers(0, 4, (32, 1)))
    ds = paddle.io.TensorDataset([xs, ys])
    net = paddle.nn.Linear(8, 4, device="cpu")
    m = paddle.Model(net)
    m.prepare(optimizer=paddle.optimizer.SGD(
        learning_rate=1e-2, parameters=net.parameters()),
        loss=paddle.nn.CrossEntropyLoss(), metrics=paddle.metric.Accuracy())
    losses, mvals = m.train_batch([xs], [ys])
    assert 0.0 <= float(mvals[0]) <= 1.0 and np.isfinite(losses[0])
    m.fit(ds, epochs=1, batch_size=8, verbose=2, log_freq=1)
    out = capsys.readouterr().out
    assert "acc" in out and "samples/s" in out and "ETA" in out


def test_eager_optimizer_trains_without_the_step():
    """An optimizer ``TrainStep`` does not take trains eagerly, as the
    reference's ``step._update_fn is None`` route does."""
    jnet, tnet = _pair("LeNet")
    out = {}
    for pkg, net, ds in ((jpaddle, jnet, jds), (paddle, tnet, tds)):
        opt = pkg.optimizer.RMSProp(learning_rate=1e-3,
                                    parameters=net.parameters())
        model = pkg.Model(net)
        model.prepare(optimizer=opt, loss=pkg.nn.CrossEntropyLoss())
        rec = _recorder(JCallback if pkg is jpaddle else TCallback)
        model.fit(ds.MNIST(size=16), batch_size=8, epochs=1, shuffle=False,
                  verbose=0, callbacks=[rec])
        out[pkg.__name__] = [b["loss"] for b in rec.batches]
        assert model._train_step is False
    np.testing.assert_allclose(out["paddle_tpu_torch"], out["paddle_tpu"],
                               rtol=1e-5)


def test_save_load_in_place(tmp_path, lenet_runs):
    """``save`` writes ``.pdparams``/``.pdopt``; ``load`` restores both
    in place into a fresh model, whose predictions are then equal bit
    for bit; ``save(training=False)`` keeps the reference's
    ``ValueError`` without specs and waits on #13 with them."""
    _, _, tm_, _ = lenet_runs
    prefix = str(tmp_path / "lenet")
    tm_.save(prefix)
    assert os.path.exists(prefix + ".pdparams")
    assert os.path.exists(prefix + ".pdopt")
    net2 = tm.LeNet(device="cpu", seed=5)
    ptrs = [p.data_ptr() for p in net2.parameters()]
    m2 = paddle.Model(net2)
    m2.prepare(optimizer=paddle.optimizer.Adam(
        parameters=net2.parameters()), loss=paddle.nn.CrossEntropyLoss())
    m2.load(prefix)
    assert [p.data_ptr() for p in net2.parameters()] == ptrs
    for (n, a), b in zip(tm_.network.state_dict().items(),
                         net2.state_dict().values()):
        assert torch.equal(a, b), n
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 1, 28, 28)).astype(np.float32))
    assert torch.equal(tm_.predict_batch([x]), m2.predict_batch([x]))
    with pytest.raises(ValueError, match="input spec"):
        m2.save(prefix, training=False)
    # with input specs, the inference artifact through jit.save
    spec = paddle.static.InputSpec((1, 1, 28, 28), "float32")
    paddle.Model(net2, inputs=[spec]).save(prefix, training=False)
    loaded = paddle.jit.load(prefix, device="cpu")
    assert torch.equal(loaded(x[:1]), net2(x[:1]))


def _summary_text(fn):
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn()
    return res, buf.getvalue()


@pytest.mark.parametrize("name,size", [("LeNet", (1, 1, 28, 28)),
                                       ("resnet18", (1, 3, 32, 32))])
def test_summary_and_flops_match_jax(name, size):
    jnet, tnet = _pair(name)
    jres, jtext = _summary_text(lambda: jpaddle.summary(jnet, size))
    tres, ttext = _summary_text(lambda: paddle.summary(tnet, size))
    assert tres == jres
    assert ttext == jtext
    jf, jft = _summary_text(lambda: jpaddle.flops(jnet, size))
    tf, tft = _summary_text(lambda: paddle.flops(tnet, size))
    assert tf == jf and tft == jft


def test_example_twin_runs_on_the_cpu(capsys, tmp_path):
    from paddle_tpu_torch.examples import resnet_cifar
    logs = resnet_cifar.main(["--epochs", "1", "--device", "cpu",
                              "--batch-size", "128"])
    assert set(logs) == {"loss", "acc"} and np.isfinite(logs["loss"])
    assert 0.0 <= logs["acc"] <= 1.0
    out = capsys.readouterr().out
    assert "epoch 0" in out and str(logs) in out
    # --export writes the artifact the Predictor serves, at any batch
    prefix = str(tmp_path / "resnet")
    resnet_cifar.main(["--device", "cpu", "--epochs", "0", "--batch-size",
                       "128", "--export", prefix])
    assert f"exported to {prefix}.ptpu_torch_model" in \
        capsys.readouterr().out
    cfg = paddle.inference.Config(prefix)
    cfg.disable_gpu()
    pred = paddle.inference.create_predictor(cfg)
    for b in (1, 3):
        out = pred.run([np.zeros((b, 3, 32, 32), np.float32)])[0]
        assert out.shape == (b, 10) and np.isfinite(out).all()


def test_example_twin_flags_are_the_reference_s():
    import ast
    from paddle_tpu_torch.examples import resnet_cifar
    path = os.path.join(REPO, "examples", "resnet_cifar.py")
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    want = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                getattr(node.func, "attr", "") == "add_argument":
            dest = node.args[0].value.lstrip("-").replace("-", "_")
            kw = {k.arg: k.value for k in node.keywords}
            want[dest] = ast.literal_eval(kw["default"]) \
                if "default" in kw else None
    got = vars(resnet_cifar.parse_args([]))
    assert got.pop("device") is None
    assert got == want
