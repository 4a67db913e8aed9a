"""Build and load the port's CUDA kernels (sources in oatx_torch/csrc/).

Each `csrc/<name>.cu` exposes a plain C interface (pointers and the stream as
`void*`, sizes as `int`) and is compiled by nvcc, by hand, into its own shared
library for sm_90a:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so csrc/<name>.cu

The libraries go into oatx_torch/_build/ (git-ignored), named by a hash of
the source and flags, so a checkout builds once and rebuilds after an edit.
All sources build in parallel (one nvcc per source, started together) at the
first kernel launch, and are loaded with ctypes. Nothing here runs at import:
every module must import on a machine without nvcc or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# what the last build printed (ptxas register / spill report)
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from oatx_torch/csrc at first use")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every csrc/*.cu whose library is missing, all in parallel.
    Returns the wall seconds spent (0 when everything was built already)."""
    todo = [s for s in sources() if not _lib_path(s).exists()]
    t0 = time.perf_counter()
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for src in todo:
            out = _lib_path(src)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            p = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
            procs.append((src, out, tmp, p))
        failed = []
        for src, out, tmp, p in procs:
            log, _ = p.communicate()
            build_logs[src.stem] = log
            if p.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
            else:
                os.replace(tmp, out)  # atomic: concurrent builders agree
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building all sources first if
    needed. Thread-safe: the serving threads may launch the first kernel."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            src = CSRC / f"{name}.cu"
            if not src.exists():
                raise FileNotFoundError(src)
            if not _lib_path(src).exists():
                build_all()
            lib = ctypes.CDLL(str(_lib_path(src)))
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry returned a CUDA error (its cudaGetLastError())."""
    if err != 0:
        lib.oatx_cuda_error_string.restype = ctypes.c_char_p
        lib.oatx_cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.oatx_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
