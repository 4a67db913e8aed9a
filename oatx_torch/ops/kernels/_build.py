"""Build and load the port's CUDA kernels (sources in oatx_torch/csrc/).

Each `csrc/<name>.cu` exposes a plain C interface (pointers and the stream as
`void*`, sizes as `int`) and is compiled by nvcc, by hand, into its own shared
library for sm_90a:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so csrc/<name>.cu

The libraries go into oatx_torch/_build/ (git-ignored), named by a hash of
the source, the shared headers (csrc/*.cuh) and the flags, so a checkout
builds once and rebuilds after an edit of either.
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
# libraries one source links beyond the CUDA runtime: nvdec.cu calls the
# driver API (the driver's libcuda, through the toolkit's stub at link time)
# and dlopens libnvcuvid
LINK_FLAGS: Dict[str, List[str]] = {"nvdec": ["-lcuda", "-ldl"]}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# what nvcc printed for each library (ptxas register / spill report); kept
# beside the library as lib<name>-<hash>.log, so a later process reads it too
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from oatx_torch/csrc at first use")


def _link_flags(nvcc: str, stem: str) -> List[str]:
    """LINK_FLAGS of a source, after -L of the toolkit's driver stubs when it
    links the driver (libcuda.so.1 of the driver is loaded at run time)."""
    flags = LINK_FLAGS.get(stem, [])
    if "-lcuda" not in flags:
        return flags
    top = Path(nvcc).resolve().parents[1]
    stubs = [d for d in (top / "lib64" / "stubs", top / "targets" / "x86_64-linux" / "lib" /
                         "stubs") if d.is_dir()]
    return [f"-L{d}" for d in stubs] + flags


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _lib_path(src: Path) -> Path:
    """The library of `src`, named by a hash of the source, every header in
    csrc/ (any source may include any of them) and the flags."""
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode() + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS.get(src.stem, [])).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every csrc/*.cu whose library is missing, all in parallel,
    and fill `build_logs`. Returns the wall seconds spent (0 when
    everything was built already)."""
    todo = [s for s in sources() if not _lib_path(s).exists()]
    t0 = time.perf_counter()
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for src in todo:
            out = _lib_path(src)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            p = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src),
                                  *_link_flags(nvcc, src.stem)],
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
                out.with_suffix(".log").write_text(log)
                os.replace(tmp, out)  # atomic: concurrent builders agree
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for src in sources():
        log = _lib_path(src).with_suffix(".log")
        if src.stem not in build_logs and log.exists():
            build_logs[src.stem] = log.read_text()
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
