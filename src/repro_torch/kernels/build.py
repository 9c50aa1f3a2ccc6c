"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on first
use into its own shared library under ``build/repro_torch/`` at the root
of the checkout, for Hopper only: ``-gencode arch=compute_90a,code=sm_90a -O3 -fmad=false``, never
fast math.  The library's file name carries a hash of its source and
flags, so an edited source rebuilds and a stale library is never
loaded.  :func:`build_all` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_KERNELS = Path(__file__).resolve().parent
_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    return _KERNELS.parents[2] / "build" / "repro_torch"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (set CUDA_HOME)")


def _target(source: Path) -> Path:
    h = hashlib.sha1(source.read_bytes() + repr(NVCC_FLAGS).encode())
    return build_dir() / f"{source.stem}_{h.hexdigest()[:16]}.so"


def build_all(sources: Sequence[Path]) -> Dict[Path, Path]:
    """Compile every source whose library is missing, all in parallel.

    Returns ``{source: library path}``.  Each build's compiler output
    (``-Xptxas -v``: registers, spills) is kept beside the library as
    ``<library>.log``.  Raises if any build fails.
    """
    out, procs = {}, []
    build_dir().mkdir(parents=True, exist_ok=True)
    for src in sources:
        lib = _target(src)
        out[src] = lib
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        Path(f"{lib}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of one source, built at first use."""
    key = str(source)
    lib = _LIBS.get(key)
    if lib is None:
        path = build_all([source])[source]
        lib = _LIBS[key] = ctypes.CDLL(str(path))
    return lib


def all_sources() -> list:
    """Every CUDA source of the port."""
    return sorted(_KERNELS.glob("*/csrc/*.cu"))
