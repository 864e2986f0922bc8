"""Op registry loaded from ``ops.yaml``: port of
``paddle_tpu/ops/registry.py``.

The port keeps its own copy of the reference's registry: every entry has
the reference's ``op``, ``args``, ``tensor_method`` and ``inplace``, and
``module`` names where the port keeps the op (the 14 ``nn.functional``
ops the reference keeps in submodules live in ``nn/functional/
__init__.py``).

- :func:`load_registry` parses the YAML (a tiny parser, no yaml module).
- :func:`resolve` maps an entry to its implementing callable.
- :mod:`paddle_tpu_torch._C_ops` is built from the registry.
"""

from __future__ import annotations

import importlib
import os
from dataclasses import dataclass
from typing import Dict, List

YAML_PATH = os.path.join(os.path.dirname(__file__), "ops.yaml")


@dataclass
class OpSpec:
    op: str
    module: str
    args: str
    tensor_method: bool
    inplace: bool


def _parse_bool(s: str) -> bool:
    return s.strip().lower() == "true"


def load_registry(path: str = YAML_PATH) -> List[OpSpec]:
    ops: List[OpSpec] = []
    cur: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.lstrip().startswith("#"):
                continue
            if line.startswith("- op:"):
                if cur:
                    ops.append(_to_spec(cur))
                cur = {"op": line.split(":", 1)[1].strip()}
            elif line.startswith("  ") and ":" in line:
                k, v = line.strip().split(":", 1)
                cur[k] = v.strip()
    if cur:
        ops.append(_to_spec(cur))
    return ops


def _to_spec(d: Dict[str, str]) -> OpSpec:
    return OpSpec(
        op=d["op"],
        module=d["module"],
        args=d.get("args", "(...)").strip('"'),
        tensor_method=_parse_bool(d.get("tensor_method", "false")),
        inplace=_parse_bool(d.get("inplace", "false")),
    )


_registry_cache = None


def registry() -> List[OpSpec]:
    global _registry_cache
    if _registry_cache is None:
        _registry_cache = load_registry()
    return _registry_cache


def registry_by_name() -> Dict[str, OpSpec]:
    return {s.op: s for s in registry()}


def resolve(spec: OpSpec):
    """Return the implementing callable for a registry entry."""
    mod = importlib.import_module(spec.module)
    return getattr(mod, spec.op)
