"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each kernel source compiles with nvcc into its own shared library with a
plain C interface, loaded with ctypes: no PyTorch headers, so a build takes
seconds, not minutes. A source may hold several entry points (optim.cu:
the AdamW update and the two passes of the sum of squares); each is one
entry of KERNELS. Libraries land in ``build/`` next to this file (listed
in .gitignore), named by the source and a hash of the sources and flags,
so an edited source rebuilds and an unchanged one is reused. ``build_all``
starts every nvcc at once.

Nothing here runs at import: the CPU tests import every module of the port
on a machine with no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
HEADERS = ("flash_common.cuh", "hopper.cuh")
# entry point -> (source, C argument types after the dtype code)
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
KERNELS = {
    "flash_fwd": ("flash_fwd.cu",
                  [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "flash_bwd_dq": ("flash_bwd_dq.cu",
                     [_P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _I, _P]),
    "flash_bwd_dkv": ("flash_bwd_dkv.cu",
                      [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _P]),
    "sum_squares": ("optim.cu", [_P, _L, _P, _I, _P]),
    "sum_partials": ("optim.cu", [_P, _I, _P, _P]),
    "adamw": ("optim.cu", [_P, _P, _P, _P, _L, _P,
                           _F, _F, _F, _F, _F, _F, _F, _F, _F, _F, _P]),
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return nvcc


def _lib_path(name: str) -> Path:
    """The library that holds entry point `name`: one per source."""
    src = KERNELS[name][0]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (src, *HEADERS):
        h.update((CSRC / f).read_bytes())
    return BUILD / f"{Path(src).stem}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, str]:
    """Compile every library of the named entry points (default: all) that
    is missing, all nvcc processes at once. Returns {source stem: ptxas
    report} for the ones built now (registers, shared memory and spills per
    instantiation). Raises on any failure."""
    names = list(names or KERNELS)
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        src = KERNELS[name][0]
        out = _lib_path(name)
        stem = Path(src).stem
        if out.exists() or stem in procs:
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one entry point, built first if missing."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_int, *KERNELS[name][1]]
            fn.restype = ctypes.c_int
            _loaded[name] = lib
        return lib
