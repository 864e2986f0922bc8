"""The port's op registry (``paddle_tpu_torch/ops/ops.yaml``): twins of
``tests/test_op_registry.py`` on the port, and the port's copy held
against the reference's entry for entry."""

import importlib
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import _C_ops
from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.ops.registry import registry, registry_by_name, resolve

torch.set_num_threads(1)

# the port's op modules (the reference's tools/gen_op_yaml.OP_MODULES)
OP_MODULES = [
    "paddle_tpu_torch.tensor.math",
    "paddle_tpu_torch.tensor.manipulation",
    "paddle_tpu_torch.tensor.creation",
    "paddle_tpu_torch.tensor.linalg",
    "paddle_tpu_torch.tensor.logic",
    "paddle_tpu_torch.tensor.search",
    "paddle_tpu_torch.tensor.random",
    "paddle_tpu_torch.tensor.stat",
    "paddle_tpu_torch.tensor.attribute",
    "paddle_tpu_torch.tensor.einsum",
]


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    from paddle_tpu_torch import device as tdevice
    prev = tdevice._layer_device
    pt.set_device("cpu")
    yield
    tdevice._layer_device = prev


def test_registry_loads_and_is_sorted():
    specs = registry()
    assert len(specs) > 350
    names = [s.op for s in specs]
    assert names == sorted(names)
    assert len(names) == len(set(names))


def test_every_entry_resolves_with_matching_signature():
    for spec in registry():
        fn = resolve(spec)
        assert callable(fn), spec.op
        sig = str(inspect.signature(fn))
        assert sig == spec.args, (
            f"{spec.op}: ops.yaml says {spec.args} but the port has {sig}")
        assert callable(getattr(_C_ops, spec.op)), spec.op


def test_no_unregistered_public_ops():
    """Every public function the port's tensor modules define appears
    in its ops.yaml (the nn.functional modules also hold the port's own
    functionals, which the reference keeps elsewhere)."""
    registered = set(registry_by_name())
    missing = []
    for mod_name in OP_MODULES:
        mod = importlib.import_module(mod_name)
        for name in getattr(mod, "__all__"):
            fn = getattr(mod, name, None)
            if not inspect.isfunction(fn) or fn.__module__ != mod_name:
                continue
            if name not in registered:
                missing.append(f"{mod_name}.{name}")
    assert not missing, f"unregistered ops {missing}"


def test_tensor_method_flags_accurate():
    """A ``tensor_method`` op is a method of the facade (torch's own
    where ``torch.Tensor`` has the name); one that is not is no method
    the facade adds; an ``inplace`` op has its ``<op>_`` form."""
    for spec in registry():
        if spec.tensor_method:
            assert hasattr(Tensor, spec.op), spec.op
        else:
            assert spec.op not in vars(Tensor), spec.op
        if spec.inplace:
            assert hasattr(Tensor, spec.op + "_"), spec.op


def test_c_ops_namespace():
    x = pt.to_tensor(np.array([[1.0, 2.0], [3.0, 4.0]], np.float32))
    y = _C_ops.matmul(x, x)
    np.testing.assert_allclose(
        y.numpy(), np.array([[7.0, 10.0], [15.0, 22.0]]), rtol=1e-6)
    assert _C_ops.add(x, x).numpy()[0, 0] == 2.0
    assert isinstance(_C_ops.relu(x), Tensor)
    assert "softmax" in dir(_C_ops)
    with pytest.raises(AttributeError, match="ops.yaml"):
        _C_ops.definitely_not_an_op


def test_registry_equals_the_references_but_module():
    """The port's ops.yaml is the reference's entry for entry: op, args,
    tensor_method and inplace equal; ``module`` is where the port keeps
    the op (the reference's module path in the port, or
    ``nn.functional``'s package for the 14 it keeps there)."""
    from paddle_tpu.ops.registry import registry as jregistry
    ref = {s.op: s for s in jregistry()}
    port = registry_by_name()
    assert list(port) == list(ref)
    moved = set()
    for op, s in port.items():
        r = ref[op]
        assert (s.args, s.tensor_method, s.inplace) == (
            r.args, r.tensor_method, r.inplace), op
        same = r.module.replace("paddle_tpu", "paddle_tpu_torch", 1)
        if s.module != same:
            assert s.module == "paddle_tpu_torch.nn.functional", op
            moved.add(op)
    assert moved == {"dropout", "dropout2d", "dropout3d", "alpha_dropout",
                     "linear", "cross_entropy", "nll_loss",
                     "softmax_with_cross_entropy", "flash_attention",
                     "scaled_dot_product_attention", "gather_tree", "gelu",
                     "relu", "layer_norm"}
