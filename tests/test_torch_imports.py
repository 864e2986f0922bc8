"""The PyTorch port stands alone: importing it loads neither JAX nor the
JAX package, its sources import neither, and its entry points refuse to
run on a machine without CUDA unless asked for the CPU."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "paddle_tpu_torch")


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import paddle_tpu_torch\n"
        "import paddle_tpu_torch.inference.serving, "
        "paddle_tpu_torch.inference.llm, paddle_tpu_torch.models.convert\n"
        "import paddle_tpu_torch.jit.train_step, "
        "paddle_tpu_torch.optimizer, paddle_tpu_torch.nn.clip, "
        "paddle_tpu_torch.distributed.utils, "
        "paddle_tpu_torch.ops.rope, paddle_tpu_torch.ops.flash_attention\n"
        "import paddle_tpu_torch.ops.quantized_matmul, "
        "paddle_tpu_torch.models.wquant, paddle_tpu_torch.quantization, "
        "paddle_tpu_torch.quantization.observers\n"
        "import paddle_tpu_torch.inference.speculative, "
        "paddle_tpu_torch.inference.sampling, "
        "paddle_tpu_torch.inference.threefry, "
        "paddle_tpu_torch.inference.prefixcache, "
        "paddle_tpu_torch.models.generation\n"
        "import paddle_tpu_torch.core.flags, paddle_tpu_torch.core.generator, "
        "paddle_tpu_torch.optimizer.lr, "
        "paddle_tpu_torch.ops.fused_optimizer\n"
        "import paddle_tpu_torch.amp, paddle_tpu_torch.amp.grad_scaler, "
        "paddle_tpu_torch.amp.debugging, paddle_tpu_torch.regularizer, "
        "paddle_tpu_torch.incubate.nn.functional, "
        "paddle_tpu_torch.optimizer.optimizer, "
        "paddle_tpu_torch.examples.llama_pretrain, "
        "paddle_tpu_torch.examples.llama_serve\n"
        "import paddle_tpu_torch.inference.router, "
        "paddle_tpu_torch.inference.transport, "
        "paddle_tpu_torch.inference.procserve, "
        "paddle_tpu_torch.observability.fleet\n"
        "import paddle_tpu_torch.inference.lora, "
        "paddle_tpu_torch.models.lora\n"
        "import paddle_tpu_torch.models.gpt, paddle_tpu_torch.models.ernie, "
        "paddle_tpu_torch.nn.transformer, paddle_tpu_torch.nn.norm, "
        "paddle_tpu_torch.nn.common\n"
        "import paddle_tpu_torch.vision.models, paddle_tpu_torch.models.ocr, "
        "paddle_tpu_torch.nn.conv, paddle_tpu_torch.nn.pooling, "
        "paddle_tpu_torch.nn.rnn, paddle_tpu_torch.nn.loss, "
        "paddle_tpu_torch.nn.activation, paddle_tpu_torch.nn.container, "
        "paddle_tpu_torch.nn.functional.conv, "
        "paddle_tpu_torch.nn.functional.loss\n"
        "import paddle_tpu_torch.hapi, paddle_tpu_torch.hapi.model, "
        "paddle_tpu_torch.hapi.callbacks, "
        "paddle_tpu_torch.hapi.model_summary, "
        "paddle_tpu_torch.hapi.dynamic_flops, paddle_tpu_torch.io, "
        "paddle_tpu_torch.io.dataloader, paddle_tpu_torch.io.sampler, "
        "paddle_tpu_torch.io.dataset, paddle_tpu_torch.metric, "
        "paddle_tpu_torch.framework.io, paddle_tpu_torch.jit.api, "
        "paddle_tpu_torch.static, paddle_tpu_torch.distributed.env, "
        "paddle_tpu_torch.vision.ops, paddle_tpu_torch.vision.datasets, "
        "paddle_tpu_torch.vision.transforms, "
        "paddle_tpu_torch.examples.resnet_cifar, paddle_tpu_torch.runtime\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'paddle_tpu' "
        "or m.startswith('paddle_tpu.'))\n"
        "print(','.join(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "", f"loaded: {res.stdout.strip()}"


def test_sources_import_no_jax():
    offenders = []
    for root, _dirs, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                else:
                    continue
                for n in names:
                    top = n.split(".")[0]
                    if top in ("jax", "jaxlib", "paddle_tpu"):
                        offenders.append(f"{path}: {n}")
    assert not offenders, offenders


def test_entry_points_need_cuda_unless_cpu_is_asked():
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.models import LlamaForCausalLM, tiny_llama_config
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LlamaForCausalLM(tiny_llama_config())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LlamaForCausalLM(tiny_llama_config(recompute=True))
    with pytest.raises(ValueError, match="device must be"):
        resolve_device("meta")
    model = LlamaForCausalLM(tiny_llama_config(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(model, num_slots=1, prompt_len=4, max_cache_len=8,
                      compute_dtype="float32")
    from paddle_tpu_torch.inference import AdapterStore
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AdapterStore(model, slots=1, max_rank=2, dtype="float32")
    eng = ServingEngine(model, num_slots=1, prompt_len=4, max_cache_len=8,
                        compute_dtype="float32", device="cpu")
    req = eng.submit(np.arange(3, dtype=np.int32), max_new_tokens=2)
    spec = eng.submit(np.arange(3, dtype=np.int32), max_new_tokens=3,
                      spec_decode=2)
    eng.run()
    assert req.output.shape == (2,) and spec.output.shape == (3,)
    out = model.generate(np.arange(3, dtype=np.int32)[None],
                         max_new_tokens=2, compute_dtype="float32")
    assert out.device.type == "cpu" and out.shape == (1, 2)


@pytest.mark.parametrize("build", [
    "GPTForCausalLM", "ErnieModel", "ErnieForSequenceClassification",
    "ErnieForPretraining", "MultiHeadAttention", "TransformerEncoderLayer",
    "Transformer", "square_mask", "resnet50", "mobilenet_v3_small",
    "vgg11", "DBNet", "CRNN", "PPOCRSystem", "Conv2D", "BatchNorm2D",
    "LSTM", "Embedding"])
def test_model_zoo_entry_points_need_cuda_unless_cpu_is_asked(build):
    from paddle_tpu_torch import models, nn
    from paddle_tpu_torch.vision import models as vision
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    make = {
        "resnet50": vision.resnet50,
        "mobilenet_v3_small": vision.mobilenet_v3_small,
        "vgg11": lambda **kw: vision.vgg11(batch_norm=True, **kw),
        "DBNet": models.DBNet,
        "CRNN": models.CRNN,
        "PPOCRSystem": models.PPOCRSystem,
        "Conv2D": lambda **kw: nn.Conv2D(3, 4, 3, **kw),
        "BatchNorm2D": lambda **kw: nn.BatchNorm2D(4, **kw),
        "LSTM": lambda **kw: nn.LSTM(4, 8, direction="bidirect", **kw),
        "Embedding": lambda **kw: nn.Embedding(10, 4, **kw),
        "GPTForCausalLM": lambda **kw: models.GPTForCausalLM(
            models.tiny_gpt_config(), **kw),
        "MultiHeadAttention": lambda **kw: nn.MultiHeadAttention(16, 2,
                                                                 **kw),
        "TransformerEncoderLayer": lambda **kw: nn.TransformerEncoderLayer(
            16, 2, 32, **kw),
        "Transformer": lambda **kw: nn.Transformer(16, 2, 1, 1, 32, **kw),
        "square_mask": lambda **kw: nn.Transformer.
        generate_square_subsequent_mask(4, **kw),
    }.get(build) or (lambda **kw: getattr(models, build)(
        models.tiny_ernie_config(), **kw))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()
    made = make(device="cpu")
    t = made if isinstance(made, torch.Tensor) else next(made.parameters())
    assert t.device.type == "cpu"


def test_engine_process_command_names_the_port():
    """The port's process supervisor launches the port: its recorded
    command imports ``paddle_tpu_torch`` (never the JAX package) and it
    sets no JAX variable in the child's environment; the child's engine
    factory defaults to the card, so without CUDA it raises instead of
    serving on the CPU."""
    import json

    from paddle_tpu_torch.inference import procserve
    ep = procserve.EngineProcess(
        "r0", "paddle_tpu_torch.inference.procserve:tiny_llama_engine",
        {"seed": 7, "device": "cpu"}, ("127.0.0.1", 1), dryrun=True)
    cmd = ep.commands[0]
    assert "paddle_tpu_torch.inference.procserve import main" in cmd[2]
    assert "paddle_tpu.inference" not in " ".join(cmd)
    assert json.loads(cmd[cmd.index("--kwargs") + 1]) == \
        {"seed": 7, "device": "cpu"}
    assert not any(k.startswith(("JAX_", "XLA_")) for k in ep._env)
    ep.restart()
    assert ep.gen == 1 and "paddle_tpu_torch" in ep.commands[1][2]
    # the spawn path adds nothing but the caller's env to the parent's
    seen = {}

    class _Popen:
        def __init__(self, cmd, env):
            seen.update(env)

        def poll(self):
            return 0

    orig = procserve.subprocess.Popen
    procserve.subprocess.Popen = _Popen
    try:
        live = procserve.EngineProcess(
            "r1", "paddle_tpu_torch.inference.procserve:tiny_llama_engine",
            {}, ("127.0.0.1", 1), env={"FOO": "1"})
    finally:
        procserve.subprocess.Popen = orig
    added = {k for k in seen if os.environ.get(k) != seen[k]}
    assert added == {"FOO"}
    live._proc = None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            procserve.tiny_llama_engine()
    eng = procserve.tiny_llama_engine(device="cpu")
    assert eng.device.type == "cpu" and eng.role == "both"


def test_slice_21_names():
    """The hapi slice's top-level names, and the two exports of the
    reference's ``nn`` that the vision slice had left out."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F
    assert nn.LinearCompute is nn.Linear
    assert F.rms_norm.__module__ == "paddle_tpu_torch.nn.functional.norm"
    x = torch.randn(2, 16)
    assert torch.equal(F.rms_norm(x, torch.ones(16)), F.rms_norm(x))
    for name in ("save", "load", "Model", "summary", "flops", "io",
                 "metric", "static", "hapi", "framework"):
        assert hasattr(paddle, name), name
    assert paddle.static.InputSpec is paddle.jit.InputSpec
    spec = paddle.static.InputSpec((1, 3), "bfloat16", "x")
    assert (spec.shape, spec.dtype, spec.name) == ((1, 3), torch.bfloat16,
                                                   "x")


@pytest.mark.parametrize("build", ["DataLoader", "DeformConv2D",
                                   "resnet_cifar", "Model.fit", "nn.Linear",
                                   "Model.fit(Linear)"])
def test_hapi_entry_points_need_cuda_unless_cpu_is_asked(build):
    from paddle_tpu_torch import io, nn, optimizer
    from paddle_tpu_torch.examples import resnet_cifar
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.vision import ops
    from paddle_tpu_torch.vision.datasets import MNIST
    from paddle_tpu_torch.vision.models import LeNet
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    ds = MNIST(size=4)

    def fit(device=None, build=LeNet):
        net = build(device=device)
        m = Model(net)
        m.prepare(optimizer.SGD(parameters=net.parameters()),
                  nn.CrossEntropyLoss())
        m.fit(ds, batch_size=2, verbose=0)
        return next(net.parameters())

    def example(device=None):
        logs = resnet_cifar.main(["--epochs", "0"] + (
            ["--device", device] if device else []))
        assert set(logs) == {"loss", "acc"}
        return torch.device(device)

    make = {
        "DataLoader": lambda device=None: io.DataLoader(
            ds, places=device).device,
        "DeformConv2D": lambda device=None: ops.DeformConv2D(
            1, 2, 3, device=device).weight.device,
        "resnet_cifar": example,
        "Model.fit": lambda device=None: fit(device).device,
        "nn.Linear": lambda device=None: nn.Linear(
            4, 2, device=device).weight.device,
        # the reference's usual hapi net: a Sequential of bare layers
        "Model.fit(Linear)": lambda device=None: fit(
            device, lambda device: nn.Sequential(
                nn.Flatten(), nn.Linear(784, 10, device=device))).device,
    }[build]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()
    assert make("cpu").type == "cpu"


def test_model_without_tensors_runs_on_the_card():
    """A network with no parameters or buffers gives ``Model`` no device
    to follow: its batches go to the card, and without CUDA it raises
    instead of running on the host."""
    import numpy as np
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.hapi import Model
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(nn.Flatten()).predict_batch([np.zeros((1, 2), np.float32)])
