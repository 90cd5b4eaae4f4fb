"""Build the hand kernels from ``kernels/csrc`` at first use.

Each CUDA source compiles with ``nvcc`` into its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), which
``kernels.ops`` loads with ``ctypes``. All sources that are not built yet
compile in parallel — one ``nvcc`` per source, all started together — into
``build/torch_kernels/`` at the root of the checkout. A library's file name
carries a hash of its source and flags, so an edited source never loads a
stale build. A failed build raises with the compiler's output.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"

# kernel name -> CUDA source under csrc/
SOURCES = {
    "gather_distance": "gather_distance.cu",
    "beam_search": "beam_search.cu",
    "flash_decode": "flash_decode.cu",
    "distance_topk": "distance_topk.cu",
    "embedding_bag": "embedding_bag.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the toolkit's
    default install, else ``nvcc`` on PATH."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the hand kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _lib_path(name: str) -> Path:
    """Build output of kernel ``name``, named by a hash of its source, the
    shared headers and the flags."""
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{h}.so"


def build() -> dict[str, float]:
    """Compile every kernel whose library is not built yet, all in
    parallel. Returns {name: seconds} for the ones
    it compiled; the compiler's report (``-Xptxas -v``: registers, shared
    memory, spills) lands in ``build/torch_kernels/<name>.log``."""
    todo = [n for n in SOURCES if not _lib_path(n).is_file()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{n}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=log,
                                     stderr=subprocess.STDOUT),
                    tmp, out, log)
    took, failed = {}, []
    for n, (p, tmp, out, log) in procs.items():
        rc = p.wait()
        log.close()
        took[n] = time.perf_counter() - t0
        if rc != 0:
            failed.append(n)
            continue
        os.replace(tmp, out)
    if failed:
        report = "\n".join(
            f"--- {n} ---\n" + (BUILD_DIR / f"{n}.log").read_text()
            for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{report}")
    return took


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it (and every
    other kernel not built yet, in parallel) at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build()
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
        return lib
