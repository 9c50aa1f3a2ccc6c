"""Fake CUDA tensors on a host whose torch was built without CUDA.

The dry-run traces the card's program: fake tensors
(``FakeTensorMode``) on device ``"cuda"``.  A CUDA build of torch (the
card's host) traces them as it is.  A CPU-only build lacks two pieces
such a trace touches: a device guard for CUDA (Python indexing and
``.to("cuda")`` set one) and CUDA hooks that make CUDA the accelerator
(the autograd engine asks for it before a backward over CUDA tensors).
``csrc/fake_cuda.cpp`` supplies both as stand-ins that run nothing on a
device; :func:`build` compiles it with the host's C++ compiler against
torch's headers into ``build/repro_torch/``.  torch reads its CUDA hooks
once, at import, so the library is loaded before torch:
:func:`python_cmd` gives the command line that does so.  In such a
process ``torch.cuda.is_available()`` stays false and a real CUDA
tensor still cannot be made.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

_SOURCE = Path(__file__).resolve().parent / "csrc" / "fake_cuda.cpp"

#: Loads torch's core libraries and the stand-ins, then runs a module as
#: ``python -m`` would: ``python -c BOOT LIBRARY MODULE ARGS...``.
BOOT = (
    "import ctypes, importlib.util, os, runpy, sys\n"
    "lib = os.path.join(os.path.dirname(importlib.util.find_spec('torch')"
    ".origin), 'lib')\n"
    "for n in ('libc10.so', 'libtorch_cpu.so'):\n"
    "    ctypes.CDLL(os.path.join(lib, n), mode=ctypes.RTLD_GLOBAL)\n"
    "ctypes.CDLL(sys.argv[1], mode=ctypes.RTLD_GLOBAL)\n"
    "sys.argv = sys.argv[2:]\n"
    "runpy.run_module(sys.argv[0], run_name='__main__', alter_sys=True)\n")


def native() -> bool:
    """Whether this torch was built with CUDA (fake CUDA tensors need no
    stand-ins)."""
    import torch

    return torch.backends.cuda.is_built()


def ready() -> bool:
    """Whether fake CUDA tensors trace in this process: a CUDA build, or
    the stand-ins loaded before torch."""
    import torch

    acc = torch.accelerator.current_accelerator()
    return native() or (acc is not None and acc.type == "cuda")


def _flags(torch_dir: Path) -> list:
    import torch

    abi = int(torch.compiled_with_cxx11_abi())
    return ["-O1", "-std=c++17", "-shared", "-fPIC",
            f"-D_GLIBCXX_USE_CXX11_ABI={abi}",
            "-I", str(torch_dir / "include"),
            "-L", str(torch_dir / "lib"), "-lc10", "-ltorch_cpu"]


def build() -> Path:
    """The stand-ins' library, compiled at first use (its name carries a
    hash of the source, the flags and torch's version)."""
    import torch

    from repro_torch.kernels.build import build_dir

    torch_dir = Path(torch.__file__).resolve().parent
    flags = _flags(torch_dir)
    h = hashlib.sha1(_SOURCE.read_bytes())
    h.update(repr((flags, torch.__version__)).encode())
    lib = build_dir() / f"fake_cuda_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("fake CUDA tensors on a torch without CUDA need "
                           "a C++ compiler (c++ or g++, or CXX)")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, str(_SOURCE), "-o", str(tmp), *flags],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {_SOURCE.name} failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def python_cmd(module: str, args=()) -> list:
    """The command line that runs ``python -m module args`` where fake
    CUDA tensors trace: as it is on a CUDA build, else through
    :data:`BOOT` with the stand-ins."""
    if native():
        return [sys.executable, "-m", module, *args]
    return [sys.executable, "-c", BOOT, str(build()), module, *args]
