"""Device resolution for the port's entry points.

Every entry point (model construction, the serving engine) runs on the
CUDA card unless the caller asks for the CPU with ``device="cpu"``.  A
machine without CUDA raises instead of quietly running on the CPU: the
CPU path exists for tests, never as a stand-in for the card.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the current CUDA device; ``"cpu"`` (or a CPU
    ``torch.device``) is honoured as asked; any CUDA device requires a
    working CUDA runtime.  Other device types are refused."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(
            f"device must be 'cuda' or 'cpu', got {str(dev)!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: paddle_tpu_torch entry points run on "
            "the GPU unless called with device='cpu'")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def dtype_name(dtype: torch.dtype) -> str:
    """numpy-style dtype name (``torch.bfloat16`` -> ``"bfloat16"``),
    the spelling the JAX package reports in ``engine_spec()``."""
    return str(dtype).rsplit(".", 1)[-1]


def to_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    """``"bfloat16"``/``"float32"``/... (or a torch dtype) -> torch
    dtype; unknown names raise ``ValueError``."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt
