"""Build and bind the CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/*.cu`` source has a plain C interface and is compiled on first
use into its own shared library under ``build/repro_torch/`` at the root of
the checkout (listed in ``.gitignore``).  The library name carries a hash of
the sources and flags, so an edited source is rebuilt and an unchanged one
is reused.  :func:`build_all` starts one ``nvcc`` per missing library, all at
once, and waits for them; ``-Xptxas -v`` keeps each kernel's register and
shared-memory report in a ``.log`` beside its library.

Nothing here runs at import time: the CPU tests import every module of the
package on machines that have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path

import torch

__all__ = ["SOURCES", "DTYPE_CODES", "BUILD_DIR", "build_all", "library",
           "build_log", "check", "check_index", "check_x", "stream_of",
           "XWindows", "check_windows"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# kernel -> (source file, C entry point, its argtypes)
SOURCES = {
    "coo_spmv": ("coo_spmv.cu", "repro_coo_spmv",
                 [_P] * 10 + [_I] * 11 + [_P]),
    "bcoo_spmv": ("bcoo_spmv.cu", "repro_bcoo_spmv",
                  [_P] * 6 + [_I] * 10 + [_P]),
    "ell_spmv": ("ell_spmv.cu", "repro_ell_spmv",
                 [_P] * 5 + [_I] * 6 + [_P]),
}
# value dtype -> code of csrc/common.cuh:DType
DTYPE_CODES = {
    torch.float32: 0,
    torch.bfloat16: 1,
    torch.float16: 2,
    torch.int8: 3,
    torch.int16: 4,
    torch.int32: 5,
}

_LIBS: dict = {}  # kernel -> bound C function (process-wide cache)


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels are "
                       "built from source at first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh") and (f.suffix == ".cuh"
                                            or f.name == SOURCES[name][0]):
            h.update(f.name.encode() + f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all(names=None) -> dict:
    """Compile every missing kernel library in parallel; returns name -> path.

    Raises:
      RuntimeError: nvcc is missing or a compilation failed (its output is
        in the message).
    """
    names = list(SOURCES if names is None else names)
    paths = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n][0])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        paths[n].with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{n}:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[n])  # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``) of a built kernel library."""
    path = _lib_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def library(name: str):
    """The bound C entry point of kernel ``name`` (builds on first use)."""
    fn = _LIBS.get(name)
    if fn is None:
        path = build_all([name])[name]
        _, symbol, argtypes = SOURCES[name]
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LIBS[name] = fn
    return fn


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed with cudaError_t {err}")


def check_index(t: torch.Tensor, device, name: str) -> None:
    """Raise unless ``t`` is a contiguous int32 tensor on ``device``."""
    if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int32 tensor on {device}; "
                         f"got {t.dtype} on {t.device}")


def check_x(x: torch.Tensor, dtype: torch.dtype, name: str) -> tuple:
    """Validate a kernel's x against its values dtype; returns (B, is_vector)."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{name} takes values of "
                        f"{sorted(str(d) for d in DTYPE_CODES)}; "
                        f"got {dtype}")
    if x.dtype != dtype:
        raise TypeError(f"x dtype {x.dtype} != values dtype {dtype}")
    if x.ndim not in (1, 2) or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (cols,) or (cols, B) tensor; "
                         f"got shape {tuple(x.shape)}")
    return (x.shape[1] if x.ndim == 2 else 1), x.ndim == 1


@dataclass(frozen=True)
class XWindows:
    """Per-part x windows of a part-axis launch.

    Part p reads x rows ``[offsets[p], offsets[p] + length)``, the
    reference's ``x_local`` of that part, and clips its column indices to
    that window.  ``offsets`` is the host copy, ``offset`` the same values
    as a (P,) int32 tensor on the kernel's device; both are built once per
    program, so a launch checks its bounds without reading the device.
    """

    offsets: tuple
    length: int
    offset: torch.Tensor

    @classmethod
    def build(cls, offsets, length: int, device) -> "XWindows":
        offsets = tuple(int(o) for o in offsets)
        return cls(offsets, int(length),
                   torch.tensor(offsets, dtype=torch.int32, device=device))

    def local(self, x: torch.Tensor, p: int) -> torch.Tensor:
        """Part p's window of x (a view)."""
        return x[self.offsets[p]: self.offsets[p] + self.length]


def check_windows(win, n_parts: int, x: torch.Tensor, name: str):
    """Validate the x windows of a launch; returns (offset pointer, length).

    ``win=None`` means every part reads the whole x from row 0.
    """
    if win is None:
        return None, x.shape[0]
    if len(win.offsets) != n_parts:
        raise ValueError(f"{name}: {len(win.offsets)} x windows for {n_parts} parts")
    if win.length < 1 or min(win.offsets) < 0 \
            or max(win.offsets) + win.length > x.shape[0]:
        raise ValueError(f"{name}: x windows of length {win.length} at "
                         f"{min(win.offsets)}..{max(win.offsets)} overrun x of "
                         f"{x.shape[0]} rows")
    check_index(win.offset, x.device, f"{name} x offsets")
    return win.offset.data_ptr(), win.length


def stream_of(t: torch.Tensor) -> int:
    """Raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
