"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into
``build/trico_tpu_torch/`` (``$TRICO_TPU_BUILD_DIR/trico_tpu_torch`` when that
is set, as for the native host library). The file name carries a hash of the
source and flags, so an edited source is rebuilt and a current one is reused.
Libraries are loaded with ``ctypes``; pointers are passed as ``c_void_p``.

Nothing here runs at import time, so the CPU tests import this module on
machines that have no ``nvcc``.
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

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"fp_kernels": _CSRC / "fp_kernels.cu"}
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "fp_kernels": {
        "tt_predict_xors": [_P, _P, _P, _I, _I, _I, _I, _P],
        "tt_predict64_xors": [_P, _P, _P, _I, _I, _I, _I, _P],
        "tt_fcm_multi_xors": [_P, _P, _I, _I, _I, ctypes.POINTER(_I), _P],
        "tt_replay": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        "tt_replay64": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        "tt_logshift": [_P, _P, _LL, _I, _I, _I, _I, _P],
        "tt_pair_compact_or": [_P, _P, _P, _LL, _I, _I, _P],
        "tt_predict_sort_scratch": [_I, _I, _I, _I, _I],
        "tt_predict_sort_xors": [_P, _P, _P, _I, _I, _I, _I, _P, _LL, _P],
        "tt_predict64_sort_xors": [_P, _P, _P, _I, _I, _I, _I, _P, _LL, _P],
    },
}
# entry points that return something other than a CUDA error code (int)
_RESTYPES = {"tt_predict_sort_scratch": _LL}


def build_dir() -> Path:
    root = os.environ.get("TRICO_TPU_BUILD_DIR")
    base = Path(root) if root else Path(__file__).resolve().parents[2] / "build"
    d = base / "trico_tpu_torch"
    d.mkdir(parents=True, exist_ok=True)
    return d


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    src = SOURCES[name].read_bytes()
    tag = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}_{tag}.so"


def build_all() -> dict[str, dict]:
    """Compile every source that has no current library, all at once (one
    ``nvcc`` process per source). Returns, per source, the library path, the
    seconds its build took (0 when it was current) and the compiler's
    ``-Xptxas -v`` report. Raises if any build fails."""
    nvcc = _nvcc()
    jobs, report = {}, {}
    for name in SOURCES:
        out = _target(name)
        if out.exists():
            report[name] = {"path": str(out), "seconds": 0.0, "log": ""}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *FLAGS, str(SOURCES[name]), "-o", str(tmp)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {"path": str(out),
                        "seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def lib(name: str = "fp_kernels") -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    with _LOCK:
        if name not in _LIBS:
            path = _target(name)
            if not path.exists():
                build_all()
            so = ctypes.CDLL(str(path))
            for fn, argtypes in _SIGNATURES[name].items():
                f = getattr(so, fn)
                f.argtypes = argtypes
                f.restype = _RESTYPES.get(fn, ctypes.c_int)
            _LIBS[name] = so
        return _LIBS[name]
