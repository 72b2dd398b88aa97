"""Build and bind the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with :mod:`ctypes` (the sources share
device helpers through ``csrc/*.cuh``: ``common.cuh`` the edge-slot sums,
``mma.cuh`` the tensor-core products, ``staged.cuh`` the cp.async gather
ring).  Every pointer and
the stream travel as ``c_void_p``; each C entry point returns
``cudaGetLastError()`` after its launch and the caller raises on non-zero.
Libraries are built at first use from the checkout's own sources into
``build/`` at the repository root, named by the hash of their source and the
shared headers, so an edited kernel is always rebuilt and an unchanged one
never is.  The compiler's report (``-Xptxas=-v``: registers, shared memory
and spills of each kernel) is kept beside each library (:func:`build_log`).
Nothing is built or loaded at import time: the CPU tests import every
module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I32, _I64, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float

#: C entry points per source, with their argument types (see the sources).
SIGNATURES = {
    "groot_spmm": {
        # x, cols, wg, out, rows, deg, groups, feat, out_gstride, bf16, stream
        "groot_ld_grouped": (_P, _P, _P, _P, _I64, _I32, _I32, _I32, _I64, _I32, _P),
        # x, cols, wg, out, rows, deg, groups, feat, out_gstride, out_rstride,
        # bf16, stream
        "groot_ld_grouped_mxu": (_P, _P, _P, _P, _I64, _I32, _I32, _I32, _I64, _I64, _I32, _P),
        # x, cols, w (or null), out, rows, deg, feat, out_rstride, mxu, round,
        # bf16, stream
        "groot_ld_bucket": (_P, _P, _P, _P, _I64, _I32, _I32, _I64, _I32, _I32, _I32, _P),
        # x, x_stride, cols, w (or null), row_chunks, part, out, n_chunks, n_hd,
        # e_t, groups, feat, valid, piece_log, out_gstride, out_rstride, round,
        # bf16, stream
        "groot_hd": (_P, _I64, _P, _P, _P, _P, _P, _I64, _I64, _I32, _I32, _I32, _I32, _I32,
                     _I64, _I64, _I32, _I32, _P),
    },
    "fused_sage": {
        # x, cols, wg (or null), w, out, rows, deg, groups, feat, w_gstride, hp,
        # out_stride, mode, bf16, stream
        "fused_ld_staged": (_P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _I64, _I32, _I64, _I32,
                            _I32, _P),
        # groups, feat, hp, mode, bf16 -> dynamic shared memory of one block (-1: none)
        "fused_ld_staged_smem": (_I32, _I32, _I32, _I32, _I32),
    },
    "flash_attention": {
        # q, k, v, o, bh, s, t, hd, group, causal, window, scale, softcap,
        # bf16, body, stream
        "flash_attention": (_P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _I32, _I32, _F32,
                            _F32, _I32, _I32, _P),
        # hd -> dynamic shared memory of one wgmma-body block
        "flash_wgmma_smem": (_I32,),
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return str(path)


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=tuple(SIGNATURES)) -> dict[str, Path]:
    """Compile every named source whose library is missing, all ``nvcc``
    processes started together; returns the library paths.  Raises with the
    compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    errors = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu (exit {proc.returncode}):\n{out}")
        else:
            paths[n].with_suffix(".log").write_text(out)
            os.replace(tmp, paths[n])  # atomic: a concurrent loader never sees half a file
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def build_log(name: str) -> str:
    """The compiler's output from building one source's library ("" when the
    library was built elsewhere)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library for one source, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build((name,))[name]))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
