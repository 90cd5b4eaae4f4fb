"""Build the hand kernels from ``kernels/csrc`` at first use.

Each CUDA source compiles with ``nvcc`` into its own shared library with a
plain C interface (no PyTorch headers), which ``kernels.ops`` loads with
``ctypes``. All sources that are not built yet compile in parallel — one
``nvcc`` per source, all started together at the first use of any — into
``build/torch_kernels/`` at the root of the checkout; a library waits only
for its own compile, so a caller can run one kernel while the others still
compile, and the process waits for any compile still running before it
exits. A library's file name carries a hash of its source and flags, so an
edited source never loads a stale build. A failed build raises with the
compiler's output.
"""
from __future__ import annotations

import atexit
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
# kernel name -> (nvcc process, temporary output, library path, log file,
# start time) of each compile still running
_PENDING: dict[str, tuple] = {}
TOOK: dict[str, float] = {}        # kernel name -> seconds its compile took


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


def start() -> None:
    """Start one ``nvcc`` for every kernel whose library is neither built
    nor being built, all at once, and return without waiting. The
    compiler's report (``-Xptxas -v``: registers, shared memory, spills)
    goes to ``build/torch_kernels/<name>.log``."""
    todo = [n for n in SOURCES
            if n not in _PENDING and not _lib_path(n).is_file()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{n}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        _PENDING[n] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       tmp, out, log, time.perf_counter())


def wait(names) -> dict[str, float]:
    """Wait for the running compiles of ``names`` -> {name: seconds from
    its start} (also kept in ``TOOK``); raises with the compiler's output
    if any failed."""
    took, failed = {}, []
    for n in names:
        if n not in _PENDING:
            continue
        p, tmp, out, log, t0 = _PENDING.pop(n)
        rc = p.wait()
        log.close()
        took[n] = TOOK[n] = time.perf_counter() - t0
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


def build() -> dict[str, float]:
    """Compile every kernel whose library is not built yet, all in
    parallel, and wait for every compile still running. Returns {name:
    seconds} for the ones it waited for."""
    start()
    return wait(list(_PENDING))


atexit.register(lambda: wait(list(_PENDING)))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it at first use
    (and starting every other kernel's build beside it, without waiting
    for them)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            start()
            wait([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
        return lib
