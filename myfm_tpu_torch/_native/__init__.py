"""ctypes loader of the native planner (planner.cc).

The planner is built at first use with the host C++ compiler (``$CXX``
or ``g++``: one translation unit, no dependencies) into
``build/myfm_tpu_torch/`` at the repository root, named by a hash of
the source and the flags, so an edited source rebuilds and an unchanged
one loads as it is.  A failed build raises with the compiler's log:
there is no silent fallback.  The numpy loops the planner replaces stay
as the plain versions the tests hold it against
(``design.greedy_color(plain=True)``, ``design_categorical._pack_tiles``
and ``_packed_rows_reference``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from ..ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "planner.cc"
CXX_FLAGS = ("-O3", "-std=c++14", "-shared", "-fPIC")

_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libplanner-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the planner if its library is missing; returns its path.
    Raises RuntimeError with the compiler's output on failure."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX") or "g++", *CXX_FLAGS, str(SOURCE), "-o",
           str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except OSError as exc:
        raise RuntimeError(
            f"the native planner needs a C++ compiler: {cmd[0]}: {exc}"
        ) from exc
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building the native planner failed ({' '.join(cmd)}):\n"
            f"{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        i64 = ctypes.c_int64
        p64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        p32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.myfm_greedy_color.restype = None
        lib.myfm_greedy_color.argtypes = [i64, i64, p64, p32, p32]
        lib.myfm_packed_rows.restype = i64
        lib.myfm_packed_rows.argtypes = [i64, p64, i64, i64]
        lib.myfm_pack_tiles.restype = None
        lib.myfm_pack_tiles.argtypes = [
            i64, i64, p64, p64, i64, i64, i64,
            p32, p32, p32, p32, p32, p32, p32, p32,
        ]
        _lib = lib
    return _lib


def greedy_color_native(n_rows: int, n_cols: int, indptr,
                        indices) -> np.ndarray:
    """Each CSC column's color [n_cols] int32 (design.greedy_color)."""
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    assign = np.zeros(n_cols, dtype=np.int32)
    _load().myfm_greedy_color(n_rows, n_cols, indptr, indices, assign)
    return assign


def packed_rows_native(counts, T: int, S: int) -> int:
    """The padded row count of the greedy packing of ``counts``."""
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    return int(_load().myfm_packed_rows(len(counts), counts, T, S))


def pack_tiles_native(order, counts, n: int, T: int, S: int):
    """The greedy tile packing (design_categorical._pack_tiles): the
    same tuple, the trailing all-pad tile included.  ``order`` holds the
    rows sorted by entity, ``n`` the row count (the pad src)."""
    lib = _load()
    order = np.ascontiguousarray(order, dtype=np.int64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    n_entities = len(counts)
    n_out = int(lib.myfm_packed_rows(n_entities, counts, T, S)) + T
    K = n_out // T
    src = np.empty(n_out, dtype=np.int32)
    slot = np.empty(n_out, dtype=np.int32)
    ent = np.empty(n_out, dtype=np.int32)
    cont_in = np.empty(K, dtype=np.int32)
    cont_out = np.empty(K, dtype=np.int32)
    last_slot = np.empty(K, dtype=np.int32)
    ent_slots = np.empty(K * S, dtype=np.int32)
    final_part = np.empty(n_entities, dtype=np.int32)
    lib.myfm_pack_tiles(
        n, n_entities, order, counts, T, S, n_out,
        src, slot, ent, cont_in, cont_out, last_slot, ent_slots,
        final_part,
    )
    return (src, slot, ent, cont_in, cont_out, last_slot,
            ent_slots.reshape(K, S), final_part)
