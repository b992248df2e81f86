"""Build the CUDA sources under `hosnerf_tpu_torch/csrc/` into shared
libraries with a plain C interface, and load them with ctypes.

Each `<name>.cu` becomes `_build/<name>-<hash>.so`, where the hash covers
the source, the shared headers (`csrc/*.cuh`) and the flags, so an edited
source rebuilds and an unchanged one is reused. Nothing is compiled at import: `load(name)` builds on first
use, and `build_all()` starts one `nvcc` per source in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("lbs_inverse", "lbs_forward", "embed_trunk", "embed_trunk_bwd",
           "proto_pairgrid")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or PATH; raises if absent."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "hosnerf_tpu_torch need the CUDA toolkit")
    return found


def target_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    for hdr in sorted(CSRC_DIR.glob("*.cuh")):
        src += hdr.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every missing library, one nvcc process per source, all
    started together. Returns {name: ptxas report} for what was built;
    raises RuntimeError with the compiler output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List = []
    for name in names:
        out = target_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    reports, failures = {}, []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"--- nvcc {name}.cu (rc {proc.returncode})\n"
                            f"{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failures:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failures))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    with _LOCK:
        if name not in _LIBS:
            build_all([name])
            _LIBS[name] = ctypes.CDLL(str(target_path(name)))
        return _LIBS[name]


def check(rc: int, lib: ctypes.CDLL, what: str) -> None:
    """Raise if a launcher returned a CUDA error code (from
    cudaGetLastError right after the launch)."""
    if rc != 0:
        msg = lib.hosnerf_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc}: {msg}")


def declare(lib: ctypes.CDLL, fn: str, argtypes) -> None:
    """Set argtypes/restype of a launcher (every launcher returns int)."""
    f = getattr(lib, fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    err = lib.hosnerf_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
