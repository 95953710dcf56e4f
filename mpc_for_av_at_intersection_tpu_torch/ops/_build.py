"""Build the port's CUDA kernels and bind them with ctypes.

Each ``csrc/*.cu`` compiles with its own ``nvcc`` process, all started
together, and the objects link into one shared library with a plain C
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# K3 and K4 round every float step on their own, as their plain versions'
# separate tensor operations do: a contracted multiply-add moves a candidate
# pose across a grid-cell boundary, or a collision point across an
# obstacle's edge.
SOURCE_FLAGS = {"astar.cu": ("--fmad=false",), "collision.cu": ("--fmad=false",)}
SMEM_LIMIT = 232448     # shared memory one CTA can have on an H100, bytes

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
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
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
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(src.name, ()), "-c", str(src), "-o", str(obj)]
        objs.append(obj)
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    logs, failed = [], []
    for src, proc in zip(_sources(), procs):
        text = proc.communicate()[0]
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{text[-4000:]}")
    tmp = out.with_name(f"{tag}.tmp")
    if not failed:
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append(f"link ({link.returncode}):\n{link.stderr[-4000:]}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("\n".join(logs))
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, out)
    return out


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "k1_num_consts": ([], _I),
    "k1_build_qp": ([_P] * 5 + [_I, _I, _I, _P] + [_P] * 7 + [_I, _I, _P], _I),
    "k1_blocks_per_sm": ([_I, _I], _I),
    "k2_solve_polish": ([_P] * 8 + [_I, _I, _I, _P, _P] + [_P] * 7 + [_P], _I),
    "ruiz_admm_all_rounds": ([_P] * 8 + [_I, _I, _I, _P, _P] + [_P] * 6 + [_P], _I),
    "polish_select": ([_P] * 8 + [_I, _I, _I, _F] + [_P] * 4 + [_P], _I),
    "admm_iterations": ([_P] * 9 + [_I, _I, _I, _I, _F, _F] + [_P] * 3 + [_P], _I),
    "admm_round_full": ([_P] * 9 + [_I, _I, _I, _I, _F, _F] + [_P] * 4 + [_P], _I),
    "admm_all_rounds": ([_P] * 9 + [_I, _I, _I, _I, _I, _F, _F] + [_P] * 4 + [_P], _I),
    "admm_blocks_per_sm": ([_I, _I, _I], _I),
    "admm_smem_bytes": ([_I, _I, _I], _I),
    "k3_num_floats": ([], _I),
    "k3_num_ints": ([], _I),
    "k3_astar": ([_P] * 8 + [_I, _I, _P, _P] + [_P] * 6 + [_P] * 3 + [_P], _I),
    "k3_blocks_per_sm": ([_I], _I),
    "k4_frontier_collision": ([_P] * 7 + [_I] * 6 + [_P], _I),
    "k4_blocks_per_sm": ([_I], _I),
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
