"""Places and device state: port of ``paddle_tpu/core/device.py`` over
``torch.cuda``.

``set_device`` is ``paddle_tpu_torch.set_device`` (``device.py``): its
device is where ``to_tensor``, the creation ops and ``Layer.
create_parameter`` put a tensor, the card unless ``"cpu"`` was asked
for; without CUDA that default raises, as every entry point does.
``CPUPlace()``, ``CUDAPlace(n)`` (``TPUPlace`` is an alias: the port's
accelerator is the card) and the strings ``"cpu"``, ``"gpu"``,
``"gpu:N"`` name a device wherever a ``place=`` is taken.

``Stream``, ``Event``, ``current_stream`` and ``stream_guard`` are
``torch.cuda``'s; the memory statistics are the caching allocator's.
``is_compiled_with_cuda()`` is true (the reference says false: it has
no CUDA).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from .. import device as _device
from ..device import set_device  # noqa: F401  (the one setter)


class Place:
    """A device descriptor (``phi::Place``): ``device_type`` is ``"cpu"``
    or ``"gpu"``."""

    def __init__(self, device_type: str, device_id: int = 0):
        self.device_type = device_type
        self.device_id = device_id

    def __repr__(self):
        if self.device_type == "cpu":
            return "Place(cpu)"
        return f"Place(gpu:{self.device_id})"

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def is_cpu_place(self):
        return self.device_type == "cpu"

    def is_gpu_place(self):
        return self.device_type == "gpu"

    is_tpu_place = is_gpu_place

    def torch_device(self) -> torch.device:
        if self.device_type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)


def CPUPlace():
    return Place("cpu", 0)


def CUDAPlace(dev_id: int = 0):
    return Place("gpu", int(dev_id))


TPUPlace = CUDAPlace


def place_of(device: torch.device) -> Place:
    if device.type == "cpu":
        return CPUPlace()
    return CUDAPlace(device.index or 0)


def to_torch_device(place) -> torch.device:
    """A ``place=`` argument (a ``Place``, ``"cpu"``, ``"gpu"``,
    ``"gpu:N"``, ``"cuda:N"`` or a ``torch.device``) as a checked torch
    device; ``None`` is ``set_device``'s device."""
    if place is None:
        return _device.layer_device()
    if isinstance(place, Place):
        place = place.torch_device()
    if isinstance(place, str):
        place = place.replace("gpu", "cuda").replace("tpu", "cuda")
    return _device.resolve_device(place)


def get_all_device_type():
    return ["cpu", "gpu"] if torch.cuda.is_available() else ["cpu"]


def device_count(device_type: Optional[str] = None) -> int:
    if device_type == "cpu":
        return 1
    return torch.cuda.device_count()


def get_device() -> str:
    """``"cpu"`` or ``"gpu:N"``: ``set_device``'s device."""
    dev = _device.layer_device()
    return "cpu" if dev.type == "cpu" else f"gpu:{dev.index}"


def current_place() -> Place:
    return place_of(_device.layer_device())


def is_compiled_with_cuda() -> bool:
    return True


def is_compiled_with_tpu() -> bool:
    return False


def synchronize(device=None):
    """Block until the card's queued work is done (a no-op without
    CUDA)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize(device)


Stream = torch.cuda.Stream
Event = torch.cuda.Event


def current_stream(device=None):
    return torch.cuda.current_stream(device)


@contextlib.contextmanager
def stream_guard(stream):
    with torch.cuda.stream(stream):
        yield stream


def memory_stats(device=None) -> dict:
    return dict(torch.cuda.memory_stats(device)) \
        if torch.cuda.is_available() else {}


def max_memory_allocated(device=None) -> int:
    return int(torch.cuda.max_memory_allocated(device)) \
        if torch.cuda.is_available() else 0


def memory_allocated(device=None) -> int:
    return int(torch.cuda.memory_allocated(device)) \
        if torch.cuda.is_available() else 0


def empty_cache():
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
