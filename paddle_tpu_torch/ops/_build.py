"""Build and load the hand-written CUDA kernels.

Each ``paddle_tpu_torch/csrc/<name>.cu`` is compiled on first use with
nvcc straight into a shared library that exposes a plain C interface,
and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/paddle_tpu_torch/<name>-<hash>.so <name>.cu

The library lands in ``build/paddle_tpu_torch/`` at the repository root
(git-ignored), keyed by a hash of the source, the shared ``csrc/*.cuh``
headers and the flags, so an edited kernel rebuilds and an unchanged one
is loaded as it is.  ``build_all``
starts one nvcc per source at once and waits for all of them.

This replaces the compile probe of the JAX package
(``paddle_tpu/ops/pallas/_common.py:14-50``) with the opposite policy: a
build failure raises, and nothing falls back to another path.  Every
pointer and the CUDA stream cross into C as ``ctypes.c_void_p``; every C
entry returns ``cudaGetLastError()`` and ``Kernel.launch`` raises when
it is not 0.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable, List, Optional, Sequence

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build",
                         "paddle_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, the toolkit's usual
    place, or the first ``nvcc`` on ``PATH``."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the port's CUDA kernels are built from source at first use")


class Kernel:
    """One CUDA source file, its shared library and its C entry point.

    ``launches`` counts the kernel launches made through ``launch``: the
    wrapper that owns this object calls ``launch`` exactly once per
    kernel launch, so a run can show that it went through the kernel.
    A replay of a captured CUDA graph calls no wrapper: the graph adds
    the launches its capture recorded (``add_launches``).  Two kernels
    may share one source (``source=``, the file's stem): they share its
    library and each keeps its own entry point and count.
    """

    def __init__(self, name: str, symbol: str, argtypes: Sequence,
                 source: Optional[str] = None):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.stem = source or name
        self.source = os.path.join(CSRC_DIR, self.stem + ".cu")
        self.launches = 0
        self._fn = None

    def library_path(self) -> str:
        """Keyed by the source, the shared headers of ``csrc/`` (which a
        source may include) and the flags."""
        h = hashlib.sha256()
        headers = sorted(f for f in os.listdir(CSRC_DIR)
                         if f.endswith(".cuh"))
        for path in [self.source] + [os.path.join(CSRC_DIR, f)
                                     for f in headers]:
            with open(path, "rb") as f:
                h.update(f.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        return os.path.join(BUILD_DIR,
                            f"{self.stem}-{h.hexdigest()[:16]}.so")

    def built(self) -> bool:
        return os.path.isfile(self.library_path())

    def _load(self):
        if self._fn is None:
            build_all([self])
            lib = ctypes.CDLL(self.library_path())
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args):
        """Call the C entry point (which launches the kernel on the
        given stream) and raise on a nonzero ``cudaGetLastError``."""
        err = self._load()(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.name}: kernel launch failed with CUDA error {err}")
        self.launches += 1


KERNELS: Dict[str, Kernel] = {}


def register(kernel: Kernel) -> Kernel:
    KERNELS[kernel.name] = kernel
    return kernel


@contextlib.contextmanager
def launches_taken_out(record: Dict[str, int]):
    """Take the launches made inside the block back out of every
    ``Kernel.launches`` and add them to ``record`` (name -> count).  A
    CUDA graph's warm-up and capture run the wrappers, so their counts
    rise, but a capture runs nothing on the card; the graph keeps what
    its capture launched and ``add_launches`` charges it per replay."""
    before = {name: k.launches for name, k in KERNELS.items()}
    try:
        yield record
    finally:
        for name, k in KERNELS.items():
            made = k.launches - before.get(name, 0)
            if made:
                record[name] = record.get(name, 0) + made
            k.launches = before.get(name, 0)


def add_launches(record: Dict[str, int]):
    """Count one replay of a captured graph: every kernel launch its
    capture recorded (``launches_taken_out``) is made again."""
    for name, n in record.items():
        KERNELS[name].launches += n


def build_all(kernels: Optional[Iterable[Kernel]] = None) -> Dict[str, str]:
    """Compile every kernel whose library is missing, one nvcc process
    per source, all started together.  Returns ``{source stem: ptxas
    report}`` for the sources built by this call.  Raises with nvcc's
    output when any build fails."""
    todo, seen = [], set()
    for k in (KERNELS.values() if kernels is None else kernels):
        if not k.built() and k.library_path() not in seen:
            seen.add(k.library_path())
            todo.append(k)
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs: List = []
    for k in todo:
        out = k.library_path()
        tmp = f"{out}.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, k.source]
        procs.append((k, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    reports, errors = {}, []
    for k, out, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"--- {k.source} (nvcc exit {p.returncode})\n{log}")
            continue
        os.replace(tmp, out)      # atomic: a reader never sees half a file
        reports[k.stem] = log
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return reports


def stream_ptr(tensor) -> int:
    """The current CUDA stream of the tensor's device, as the integer
    value of its ``cudaStream_t``, for a C entry point.  The C entry
    launches on the CURRENT device, so a tensor on another device is
    refused.  Asked of torch at every call (two calls into its C++ core,
    no Stream object built): nothing is cached, so a launch always goes
    to the stream that is current at the time."""
    dev = tensor.get_device()
    cur = torch._C._cuda_getDevice()
    if dev != cur:
        raise ValueError(f"kernel operands are on {tensor.device} but the "
                         f"current CUDA device is {cur}")
    return torch._C._cuda_getCurrentRawStream(dev)


def ptr(tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(tensor.data_ptr())
