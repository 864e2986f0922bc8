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
        "paddle_tpu_torch.models.generation\n"
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
