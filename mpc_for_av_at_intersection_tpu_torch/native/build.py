"""Build and load the native lattice search (C++, bound with ctypes).

Port of ``mpc_for_av_at_intersection_tpu/native/build.py``. The shared
object is compiled from this package's ``lattice_search.cpp`` with
``g++ -O3 -shared -fPIC -std=c++17`` at first use, into the port's
git-ignored ``_build/``, named by a hash of the source and the flags. The
compiler writes under a name of its own process and thread, and the result
is moved into place with ``os.replace``, so builds that run at the same
moment (test workers, threads) never load a half-written file.

No ``-march=native``: the library is built on whichever machine runs the
program, and code tuned to one host's instruction set is no gain for a
search that is bound by its hash map. ``-ffp-contract=off`` keeps every
multiply and add rounded on its own, as the Python search rounds them, so
the two agree bit for bit on any host. Callers fall back to the Python
search when no compiler is present (``native_available()`` is False).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Optional

_DIR = pathlib.Path(__file__).resolve().parent
SOURCE = _DIR / "lattice_search.cpp"
BUILD_DIR = _DIR.parent / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def library_path(build_dir: pathlib.Path = BUILD_DIR) -> pathlib.Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return pathlib.Path(build_dir) / f"liblattice_search-{h.hexdigest()[:16]}.so"


def build(build_dir: pathlib.Path = BUILD_DIR) -> pathlib.Path:
    """Compile the search unless a library of the same source and flags
    exists; raise if the compiler fails or is missing."""
    out = library_path(build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def load_native() -> Optional[ctypes.CDLL]:
    """The native library, built on first use; None if it cannot be built."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, subprocess.CalledProcessError, subprocess.TimeoutExpired):
            _failed = True
            return None
        c_double_p = ctypes.POINTER(ctypes.c_double)
        c_i64_p = ctypes.POINTER(ctypes.c_int64)
        c_i32_p = ctypes.POINTER(ctypes.c_int32)
        lib.lattice_search.restype = ctypes.c_int
        lib.lattice_search.argtypes = [
            ctypes.c_int, c_double_p, c_double_p, c_double_p, c_i64_p,
            c_double_p, c_i64_p, ctypes.c_int,
            c_double_p, c_double_p, c_double_p, ctypes.c_double,
            c_double_p, ctypes.c_int64,
            c_double_p, c_i32_p, ctypes.c_int32, c_i32_p, c_double_p, c_i64_p,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_native() is not None
