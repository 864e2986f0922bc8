"""The port's Predictor (``paddle_tpu_torch.inference``: ``Config``,
``create_predictor``, the IO handles, ``clone``) held against the JAX
package's on the CPU, case for case with ``tests/test_inference.py``, on
the same numpy inputs and bridged weights, plus:

- the Predictor half of ``tests/test_quantization.py:308``
  (``test_int8_ptq_through_predictor``: PTQ, convert, the GELU fused into
  the quantized matmul, ``jit.save``, ``create_predictor``), within
  ``rtol 1e-4, atol 1e-5`` of the converted model and of the
  reference's Predictor;
- a tiny Llama saved at ``[2, 16]`` by both packages and run through
  both Predictors: logits within ``1e-4``;
- each run holds cuDNN's TF32 off around the program's float32
  convolutions (an exported graph cannot carry the eager layers' switch);
- the graph path (one captured graph per input signature, inputs staged
  into its buffers under ``enable_memory_optim``, outputs copied out)
  with an eager stand-in for the CUDA graph, as the card runs it.

Float32 outputs agree within ``1e-5`` unless said otherwise.
"""

import os
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import inference as rinf
from paddle_tpu import nn as jnn
from paddle_tpu_torch import inference, jit as tjit
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.jit import InputSpec


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bridge_linear(jlin, tlin):
    with torch.no_grad():
        tlin.weight.copy_(torch.tensor(np.asarray(jlin.weight._value)).t())
        tlin.bias.copy_(torch.tensor(np.asarray(jlin.bias._value)))


def _cpu(prefix):
    cfg = inference.Config(prefix)
    cfg.disable_gpu()
    return cfg


@pytest.fixture(scope="module")
def saved_model(tmp_path_factory):
    paddle.seed(7)
    jnet = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    tnet = tnn.Sequential(tnn.Linear(8, 16, device="cpu"), tnn.ReLU(),
                          tnn.Linear(16, 4, device="cpu"))
    _bridge_linear(jnet[0], tnet[0])
    _bridge_linear(jnet[2], tnet[2])
    d = tmp_path_factory.mktemp("infer")
    rprefix, prefix = str(d / "ref"), str(d / "port")
    paddle.jit.save(jnet, rprefix,
                    input_spec=[paddle.static.InputSpec([2, 8], "float32")])
    tjit.save(tnet, prefix, input_spec=[InputSpec([2, 8], "float32")])
    x = np.random.default_rng(0).standard_normal((2, 8)).astype("float32")
    expected = jnet(paddle.to_tensor(x)).numpy()
    np.testing.assert_allclose(tnet(torch.tensor(x)).detach().numpy(),
                               expected, rtol=1e-5, atol=1e-6)
    return prefix, rprefix, x, expected


def test_predictor_handle_workflow(saved_model):
    prefix, rprefix, x, expected = saved_model
    outs = []
    for mod, cfg in ((rinf, rinf.Config(rprefix)), (inference, _cpu(prefix))):
        cfg.enable_memory_optim()
        predictor = mod.create_predictor(cfg)
        in_names = predictor.get_input_names()
        assert in_names == ["input_0"]
        h = predictor.get_input_handle(in_names[0])
        assert h.shape() == [2, 8]
        h.copy_from_cpu(x)
        assert predictor.run() is True
        out_names = predictor.get_output_names()
        assert out_names == ["output_0"]
        outs.append(predictor.get_output_handle(out_names[0]).copy_to_cpu())
        # the staged (donated) input is consumed by the run
        with pytest.raises(RuntimeError, match="not set"):
            predictor.run()
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(outs[1], expected, rtol=1e-5, atol=1e-5)


def test_predictor_direct_run(saved_model):
    prefix, rprefix, x, expected = saved_model
    want = rinf.create_predictor(rinf.Config(rprefix)).run([x])[0]
    outs = inference.create_predictor(_cpu(prefix)).run([x])
    np.testing.assert_allclose(outs[0], want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(outs[0], expected, rtol=1e-5, atol=1e-5)


def test_predictor_clone_shares_weights(saved_model):
    prefix, _, x, expected = saved_model
    p1 = inference.create_predictor(_cpu(prefix))
    p2 = p1.clone()
    assert p2._param_values is p1._param_values
    assert p2._shared.lock is p1._shared.lock
    assert p2._shared.graphs is p1._shared.graphs
    results = {}

    def serve(pred, key):
        results[key] = pred.run([x])[0]

    t1 = threading.Thread(target=serve, args=(p1, "a"))
    t2 = threading.Thread(target=serve, args=(p2, "b"))
    t1.start(); t2.start(); t1.join(); t2.join()
    np.testing.assert_allclose(results["a"], expected, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(results["b"], expected, rtol=1e-5, atol=1e-5)


def test_predictor_errors(saved_model):
    prefix, rprefix, _, _ = saved_model
    for mod, cfg, none in ((rinf, rinf.Config(rprefix), rinf.Config()),
                           (inference, _cpu(prefix), inference.Config())):
        predictor = mod.create_predictor(cfg)
        with pytest.raises(RuntimeError, match="not set"):
            predictor.run()
        with pytest.raises(RuntimeError, match="run"):
            predictor.get_output_names()
        with pytest.raises(ValueError, match="model path"):
            mod.create_predictor(none)


def test_compilation_cache_dir(saved_model, tmp_path):
    prefix, _, x, expected = saved_model
    cache = str(tmp_path / "cache")
    config = _cpu(prefix)
    config.set_compilation_cache_dir(cache)
    outs = inference.create_predictor(config).run([x])
    np.testing.assert_allclose(outs[0], expected, rtol=1e-5, atol=1e-5)
    # made, as the reference's; the port compiles nothing into it
    assert os.path.isdir(cache) and not os.listdir(cache)


def test_bf16_export_precision_and_config_knobs(tmp_path):
    paddle.seed(0)
    jnet = jnn.Sequential(jnn.Linear(8, 16), jnn.Tanh(), jnn.Linear(16, 4))
    tnet = tnn.Sequential(tnn.Linear(8, 16, device="cpu"), tnn.Tanh(),
                          tnn.Linear(16, 4, device="cpu"))
    _bridge_linear(jnet[0], tnet[0])
    _bridge_linear(jnet[2], tnet[2])
    spec = [InputSpec((2, 8), "float32")]
    tjit.save(tnet, str(tmp_path / "bf16"), input_spec=spec,
              precision="bfloat16")
    tjit.save(tnet, str(tmp_path / "fp32"), input_spec=spec)
    paddle.jit.save(jnet, str(tmp_path / "rbf16"),
                    input_spec=[paddle.static.InputSpec((2, 8), "float32")],
                    precision="bfloat16")

    cfg = _cpu(str(tmp_path / "bf16"))
    cfg.enable_memory_optim(True)
    cfg.set_tpu_device_id(0)
    cfg.set_cpu_math_library_num_threads(2)
    assert cfg.memory_optim_enabled() and cfg.tpu_device_id() == 0
    assert "cuda-graph-per-signature" in cfg.pass_builder().all_passes()[0]
    assert "input_donation" in cfg.pass_builder().all_passes()
    cfg.delete_pass("input_donation")
    assert not cfg.memory_optim_enabled()
    cfg.set_compilation_cache_dir(str(tmp_path / "cache"))
    assert "persistent_compile_cache" in cfg.pass_builder().all_passes()
    cfg.enable_memory_optim(True)
    cfg.switch_ir_optim(False)
    assert not cfg.memory_optim_enabled()
    assert "persistent_compile_cache" not in cfg.pass_builder().all_passes()
    cfg.switch_ir_optim(True)
    assert cfg.memory_optim_enabled()
    assert "persistent_compile_cache" in cfg.pass_builder().all_passes()
    pred = inference.create_predictor(cfg)
    assert pred.precision_mode() == "bfloat16"

    x = np.random.default_rng(0).standard_normal((2, 8)).astype(np.float32)
    out_bf16 = pred.run([x])[0]
    pred32 = inference.create_predictor(_cpu(str(tmp_path / "fp32")))
    assert pred32.precision_mode() is None
    out_fp32 = pred32.run([x])[0]
    np.testing.assert_allclose(out_bf16, out_fp32, atol=0.1, rtol=0.05)
    assert not np.array_equal(out_bf16, out_fp32)
    # the same bf16 program as the reference's: the reference's weights
    # are the port's cast, and the two runs agree to bf16 rounding
    rout = rinf.create_predictor(rinf.Config(str(tmp_path / "rbf16"))).run(
        [x])[0]
    np.testing.assert_allclose(out_bf16, np.asarray(rout, np.float32),
                               atol=2e-2, rtol=2e-2)
    import pickle
    with open(str(tmp_path / "bf16") + ".ptpu_params", "rb") as f:
        meta = pickle.load(f)
    assert meta["dtypes"][0] == "bfloat16" and \
        meta["values"][0].dtype == np.uint16
    with open(str(tmp_path / "rbf16") + ".ptpu_params", "rb") as f:
        rmeta = pickle.load(f)
    # the stored bf16 bits are the reference's (its Linear weights are
    # [in, out], torch's [out, in])
    ref = dict(zip(rmeta["names"], rmeta["values"]))
    for name, a in zip(meta["names"], meta["values"]):
        b = np.asarray(ref[name]).view(a.dtype)
        np.testing.assert_array_equal(a, b.T if b.ndim == 2 else b)
    assert pred.clone().precision_mode() == "bfloat16"


def test_int8_ptq_through_predictor(tmp_path):
    """The Predictor half of the reference's case: PTQ, convert, fold the
    GELU into the quantized matmul, export and serve."""
    from paddle_tpu import quantization as jq
    from paddle_tpu_torch import quantization as tq
    from paddle_tpu_torch.nn import quant as tnq
    paddle.seed(0)
    jm = jnn.Sequential(jnn.Linear(32, 64), jnn.GELU(), jnn.Linear(64, 16))
    tm = tnn.Sequential(tnn.Linear(32, 64, device="cpu"), tnn.GELU(),
                        tnn.Linear(64, 16, device="cpu"))
    _bridge_linear(jm[0], tm[0])
    _bridge_linear(jm[2], tm[2])
    jm.eval()
    tm.eval()
    rng = np.random.default_rng(0)
    calib = [rng.standard_normal((8, 32)).astype(np.float32)
             for _ in range(4)]
    for pkg, m, wrap in ((jq, jm, paddle.to_tensor),
                         (tq, tm, torch.tensor)):
        ptq = pkg.PTQ(pkg.QuantConfig(activation=pkg.AbsmaxObserver,
                                      weight=None))
        ptq.quantize(m)
        for batch in calib:
            m(wrap(batch))
        ptq.convert(m)
        assert pkg.fuse_act_into_quant_linear(m) == 1
    assert any(isinstance(s, tnq.QuantizedLinearInfer) for s in tm.modules())
    q_out = tm(torch.tensor(calib[0])).detach().numpy()
    paddle.jit.save(jm, str(tmp_path / "r"),
                    input_spec=[paddle.static.InputSpec([8, 32], "float32")])
    tjit.save(tm, str(tmp_path / "p"),
              input_spec=[InputSpec([8, 32], "float32")])
    want = rinf.create_predictor(rinf.Config(str(tmp_path / "r"))).run(
        [calib[0]])[0]
    out = inference.create_predictor(_cpu(str(tmp_path / "p"))).run(
        [calib[0]])[0]
    np.testing.assert_allclose(out, q_out, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out, np.asarray(want), rtol=1e-4, atol=1e-5)


def test_tiny_llama_parity_through_both_predictors(tmp_path):
    from paddle_tpu import models as jmodels
    from paddle_tpu_torch.models import (LlamaForCausalLM,
                                         llama_state_from_jax,
                                         tiny_llama_config)
    paddle.seed(11)
    jnet = jmodels.LlamaForCausalLM(jmodels.tiny_llama_config())
    arrays = {n: np.array(p._value, copy=True)
              for n, p in jnet.named_parameters()}
    tnet = LlamaForCausalLM(tiny_llama_config(), device="cpu", init=False)
    tnet.load_state_dict(llama_state_from_jax(arrays), strict=True)
    ids = np.random.default_rng(3).integers(0, 256, (2, 16)).astype(np.int64)
    paddle.jit.save(jnet, str(tmp_path / "r"),
                    input_spec=[paddle.static.InputSpec([2, 16], "int32")])
    tjit.save(tnet, str(tmp_path / "p"),
              input_spec=[InputSpec([2, 16], "int64")])
    want = rinf.create_predictor(rinf.Config(str(tmp_path / "r"))).run(
        [ids.astype(np.int32)])[0]
    pred = inference.create_predictor(_cpu(str(tmp_path / "p")))
    h = pred.get_input_handle("input_0")
    h.copy_from_cpu(ids)
    pred.run()
    got = pred.get_output_handle("output_0").copy_to_cpu()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(
        got, tnet(torch.tensor(ids)).detach().numpy())


def test_run_holds_tf32_off_around_float32_convolutions(tmp_path):
    from torch.utils._python_dispatch import TorchDispatchMode
    from paddle_tpu_torch.vision.models import LeNet
    net = LeNet(device="cpu", seed=0)
    tjit.save(net, str(tmp_path / "lenet"),
              input_spec=[InputSpec([None, 1, 28, 28], "float32")])
    pred = inference.create_predictor(_cpu(str(tmp_path / "lenet")))
    seen = []

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if "convolution" in str(func):
                seen.append((str(func), torch.backends.cudnn.allow_tf32))
            return func(*args, **(kwargs or {}))

    torch.backends.cudnn.allow_tf32 = True
    x = np.random.default_rng(1).standard_normal((3, 1, 28, 28)).astype(
        np.float32)
    with Watch():
        out = pred.run([x])[0]
    assert seen and not any(tf32 for _, tf32 in seen), seen
    assert torch.backends.cudnn.allow_tf32      # restored after the run
    np.testing.assert_allclose(out, net(torch.tensor(x)).detach().numpy(),
                               rtol=1e-5, atol=1e-6)


def _graph_standin(monkeypatch):
    """An eager stand-in for the CUDA graph (``llm._dense_capture``) on the
    graph path, as the card runs it; returns the list of graphs made."""
    from paddle_tpu_torch.inference import llm, predictor as pm
    made = []

    class Standin:
        def __init__(self, fn, dev, warmup=None):
            self.fn = fn
            self.out = fn()
            made.append(self)

        def replay(self):
            for o, n in zip(self.out, self.fn()):
                o.copy_(n)
            return self.out

    monkeypatch.setattr(pm, "graphs_on", lambda device: True)
    monkeypatch.setattr(llm, "_dense_capture", Standin)
    return made


def test_graph_path_stages_inputs_and_copies_outputs(saved_model,
                                                     monkeypatch):
    """The card's path with an eager stand-in for the CUDA graph: one
    graph per input signature, inputs staged under ``enable_memory_optim``
    into the predictor's own buffer (reused from feed to feed, never the
    graph's), outputs copied out of the graph's buffers."""
    prefix, _, x, expected = saved_model
    made = _graph_standin(monkeypatch)
    cfg = _cpu(prefix)
    cfg.enable_memory_optim()
    pred = inference.create_predictor(cfg)
    outs = [pred.run([x])[0], pred.run([2 * x])[0]]
    assert len(made) == 1
    g = next(iter(pred._shared.graphs.values()))
    h = pred.get_input_handle("input_0")
    h.copy_from_cpu(x)
    buf = h._array
    assert buf is not g.inputs[0]           # the predictor's, not the graph's
    pred.run()
    staged = pred.get_output_handle("output_0").copy_to_cpu()
    assert h._array is None and len(made) == 1
    h.copy_from_cpu(2 * x)
    assert h._array is buf                  # the buffer is reused
    pred.run()
    np.testing.assert_allclose(outs[0], expected, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(staged, expected, rtol=1e-5, atol=1e-5)
    assert not np.allclose(outs[1], outs[0])
    # outputs are copies: the next replay does not change them
    first = pred.run([x])[0]
    pred.run([3 * x])
    np.testing.assert_allclose(first, expected, rtol=1e-5, atol=1e-5)


def test_clones_staging_different_inputs_keep_them_apart(saved_model,
                                                         monkeypatch):
    """Two clones share the graph of a signature; each one's staged feed
    stays its own until its run, in turn and from two threads."""
    prefix, _, x, expected = saved_model
    made = _graph_standin(monkeypatch)
    cfg = _cpu(prefix)
    cfg.enable_memory_optim()
    a = inference.create_predictor(cfg)
    b = a.clone()
    x2 = np.asarray(-3 * x, np.float32)
    want2 = b.run([x2])[0]
    assert not np.allclose(want2, expected)
    ha, hb = (p.get_input_handle("input_0") for p in (a, b))
    ha.copy_from_cpu(x)
    hb.copy_from_cpu(x2)
    a.run()
    b.run()
    np.testing.assert_allclose(
        a.get_output_handle("output_0").copy_to_cpu(), expected, rtol=1e-5,
        atol=1e-5)
    np.testing.assert_array_equal(
        b.get_output_handle("output_0").copy_to_cpu(), want2)
    assert len(made) == 1 and a._shared.graphs is b._shared.graphs

    results, barrier = {}, threading.Barrier(2)

    def serve(pred, feed, key):
        h = pred.get_input_handle("input_0")
        for i in range(20):
            h.copy_from_cpu(feed)
            barrier.wait()
            pred.run()
            results[key, i] = pred.get_output_handle(
                "output_0").copy_to_cpu()

    threads = [threading.Thread(target=serve, args=(a, x, "a")),
               threading.Thread(target=serve, args=(b, x2, "b"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(20):
        np.testing.assert_allclose(results["a", i], expected, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(results["b", i], want2)
