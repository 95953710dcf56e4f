"""Build the port's CUDA kernels and bind them with ctypes.

``csrc/*.cu`` compile with ``nvcc`` into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds). The library goes
into ``_build/`` inside the package, named by a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is reused. The
build runs at the first kernel launch, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
# sm_90a: Hopper with its architecture-specific instructions. No fast math:
# approximate sin/cos/tan/sqrt/division would move the polish accept test.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: building the CUDA kernels needs the CUDA "
                       "toolkit on PATH or under CUDA_HOME")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmpc_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library of the same sources exists.
    The compiler's output (registers, shared memory, spills per kernel)
    is kept beside the library as ``.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-6000:]}")
    os.replace(tmp, out)
    return out


_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "k1_num_consts": ([], _I),
    "k1_build_qp": ([_P] * 5 + [_I, _I, _P] + [_P] * 7 + [_P], _I),
    "k2_solve_polish": ([_P] * 8 + [_I, _I, _I, _P, _P] + [_P] * 7 + [_P], _I),
}


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with every entry point's
    argument and result types declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib


def check_cuda(name: str, t: torch.Tensor, shape, dtype=torch.float32):
    """Raise unless ``t`` is a contiguous CUDA tensor of this shape and dtype."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def raise_on_error(kernel: str, err: int):
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error code {err}")


def stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
