"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so
a build takes seconds).  Libraries go to ``build/myfm_tpu_torch/`` at the
repository root, named by a hash of the source, of every header it
includes from ``csrc/`` and of the flags, so an edited source or header
rebuilds and an unchanged one loads as it is.  Nothing is
built at import time: ``load`` builds on first use, and ``build_all``
starts one ``nvcc`` per source at once.  ``VARIANTS`` names libraries
built from a source with extra flags, for measurement tools only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "myfm_tpu_torch"
SOURCES = (
    "fused_gram_cross", "joint_tail", "gram_sections", "entity_draws",
)
# library name -> (source, extra nvcc flags); built only when asked for
VARIANTS = {
    "joint_tail_timed": ("joint_tail", ("-DMYFM_JOINT_TAIL_TIMED",)),
}
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from csrc/ at first "
        "use and need the CUDA toolkit"
    )


def source_files(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every file it includes with quotes,
    recursively, each once, in the order they are first included."""
    seen: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            todo.append((path.parent / inc.decode()).resolve())
    return seen


def _recipe(name: str) -> Tuple[str, Tuple[str, ...]]:
    """The source of library ``name`` and its flags."""
    source, extra = VARIANTS.get(name, (name, ()))
    return source, NVCC_FLAGS + extra


def library_path(name: str) -> Path:
    source, flags = _recipe(name)
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in source_files(source):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str) -> Tuple[subprocess.Popen, Path, Path]:
    lib = library_path(name)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    source, flags = _recipe(name)
    cmd = [_nvcc(), *flags, "-o", str(tmp), str(CSRC / f"{source}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, lib


def build_all(names=SOURCES) -> Dict[str, str]:
    """Compile every missing library in parallel; returns each newly
    built source's compiler log (``-Xptxas -v``: registers, shared
    memory, spills).  Raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs: List[Tuple[str, subprocess.Popen, Path, Path]] = []
    for name in names:
        if not library_path(name).exists():
            jobs.append((name, *_start(name)))
    logs = {}
    failed = []
    for name, proc, tmp, lib in jobs:
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (``csrc/<name>.cu`` or one of
    ``VARIANTS``), built if missing."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib


def ptxas_summary(log: str) -> List[str]:
    """'kernel<type[, flag]>: N regs' per entry function of an nvcc
    -Xptxas -v log, with its stack frame and spills where it has any."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"entry function '.*?\d([a-z_]+_kernel)I([fd])"
                      r"((?:Lb[01]E|Li\d+E)*)E", line)
        if m:
            dtype = "float" if m.group(2) == "f" else "double"
            flags = "".join(f", {f}" for f in re.findall(r"L[bi](\d+)E",
                                                         m.group(3)))
            name, spill = f"{m.group(1)}<{dtype}{flags}>", ""
        if "spill" in line and " 0 bytes spill stores" not in line:
            spill = f" ({line.strip()})"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} regs{spill}")
            name = None
    return out
