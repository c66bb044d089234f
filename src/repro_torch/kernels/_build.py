"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` exposes a plain C interface: one ``*_launch`` function
per kernel that launches on the stream it is given and returns
``cudaGetLastError()``. At first use each source is compiled by ``nvcc``
into its own shared library under ``src/repro_torch/_build/`` (listed in
``.gitignore``) and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is reused. :func:`build` starts one
``nvcc`` per source, all together. No fast-math: η needs IEEE ``sqrtf``.

:class:`Kernel` is one C entry point with its launch count: ``launches``
goes up by one each time the kernel is launched and nowhere else, so a run
can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def sources() -> list[str]:
    return sorted(p.name for p in CSRC.glob("*.cu"))


def library_path(source: str) -> Path:
    src = CSRC / source
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:12]}.so"


def build(names=None) -> dict[str, float]:
    """Compile the named sources (default: all of ``csrc/``) that have no
    up-to-date library yet, one ``nvcc`` per source, started together.
    Returns the wall seconds each compile took (0.0 when reused)."""
    names = sources() if names is None else list(names)
    todo = {s: library_path(s) for s in names
            if not library_path(s).is_file()}
    seconds = {s: 0.0 for s in names}
    if not todo:
        return seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    for src, target in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [exe, *NVCC_FLAGS, "-o", tmp, str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, target, time.perf_counter())
    failed = []
    for src, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[src] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{src}:\n{log}")
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built first if needed."""
    lib = _LIBS.get(source)
    if lib is None:
        build([source])
        lib = _LIBS[source] = ctypes.CDLL(str(library_path(source)))
    return lib


#: every Kernel defined by the port's kernel modules, in definition order
KERNELS: list["Kernel"] = []


class Kernel:
    """One ``extern "C"`` launcher of a ``csrc`` library and its launch
    count. Arguments are passed as ctypes converts them: pointers and the
    stream as Python ints (``c_void_p``), sizes as ``c_int``, scalars as
    ``c_float``."""

    def __init__(self, name: str, source: str, symbol: str, argtypes):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        KERNELS.append(self)

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.name}: kernel launch failed with CUDA error {err}")
        self.launches += 1


P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a Python int."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda_f32(name: str, *tensors) -> None:
    """Raise unless every tensor given (None entries skipped) is a
    contiguous float32 CUDA tensor, all on one device."""
    devices = set()
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"{name}: expected contiguous float32 CUDA tensors, got "
                f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
        devices.add(t.device)
    if len(devices) > 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")


def aligned16(*tensors) -> bool:
    """True when every tensor given starts on a 16-byte boundary (float4
    loads)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors if t is not None)
