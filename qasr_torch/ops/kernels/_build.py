"""Build and load the port's hand-written CUDA kernels.

At first use, every ``qasr_torch/csrc/*.cu`` is compiled by ``nvcc`` for
Hopper (``sm_90a``), one ``nvcc -c`` per source, all started together, and
the objects are linked into one shared library with a plain C interface,
``qasr_torch/_build/libqasr_kernels.so``, which is loaded with ``ctypes``.
The library is rebuilt when any source (``*.cu`` or ``*.cuh``) is newer than
it. A failure to build raises; nothing falls back.

Every C entry returns a ``cudaError_t``; :func:`check` raises on a nonzero
one with CUDA's own message.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libqasr_kernels.so")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
#: what the last build printed (nvcc's ``-Xptxas -v`` register and shared
#: memory report) and how long it took; empty when the library was current
build_log = ""
build_seconds = 0.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_ENTRIES = {
    # x, wc, bias, alpha, out, B, F, T, Cin, Cout, kh, kw, dtype, v, o, stream
    "qasr_qconv_ft8": [_P, _P, _P, _P, _P] + [_I] * 8 + [_P, _P, _P],
    "qasr_qconv_ft10": [_P, _P, _P, _P, _P] + [_I] * 8 + [_P, _P, _P],
    # x4, wc, y4, M, K, N, dtype, v, o, stream
    "qasr_qgemm8": [_P, _P, _P] + [_I] * 4 + [_P, _P, _P],
    "qasr_qgemm10": [_P, _P, _P] + [_I] * 4 + [_P, _P, _P],
    # x4, dy4, part, dw, M, K, N, splits, dtype, x_combo, out_combo, w_combo, stream
    "qasr_qgemm10_dw": [_P] * 4 + [_I] * 5 + [_P] * 4,
    # dz, wc, z, alpha, dx, partials, dalpha, B, F, T, Cin, Cout, kh, kw, dtype,
    # v, o, stream
    "qasr_qconv_dx8": [_P] * 7 + [_I] * 8 + [_P, _P, _P],
    "qasr_qconv_dx10": [_P] * 7 + [_I] * 8 + [_P, _P, _P],
    # B, F, T
    "qasr_qconv_dx8_partial_rows": [_I] * 3,
    # xz, wc8, lengths, hs, cs, gates, xc, bar, T, D, B, H, dtype, v8, o8, stream
    "qasr_qlstm_scan8": [_P] * 8 + [_I] * 5 + [_P] * 3,
    # gates, cs, dhs, wc8, lengths, dz, part, dh, dc, bar, T, D, B, H, dtype, v8,
    # o8, stream
    "qasr_qlstm_scan8_bwd": [_P] * 10 + [_I] * 5 + [_P] * 3,
    # x, y, part, out, M, K, N, splits, rows, dtype, stream
    "qasr_dgt": [_P] * 4 + [_I] * 6 + [_P],
    # x, alpha, dz, xc, dzc, part, db, B, F, T, Cin, Cout, P, dtype, v, o, stream
    "qasr_qconv_dw_prep": [_P] * 7 + [_I] * 7 + [_P] * 3,
    # B, F, T
    "qasr_qconv_dw_prep_blocks": [_I] * 3,
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "qasr_torch CUDA kernels are built from source at first use"
    )


def sources() -> tuple[list[str], list[str]]:
    """The ``.cu`` sources under ``csrc``, and those with the headers."""
    cu = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    deps = cu + sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    return cu, deps


def _stale(deps: list[str]) -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(d) > built for d in deps)


def _run(procs: list[tuple[str, subprocess.Popen]]) -> str:
    """Wait for every process; raise if any failed. Returns their output."""
    log, failed = [], []
    for what, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {what}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{what} ({proc.returncode})")
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n" + "\n".join(log))
    return "\n".join(log)


def compile_library(cu: list[str], lib_path: str) -> str:
    """``nvcc -c`` every source in ``cu`` (all started together; headers
    from ``csrc``), link the objects into ``lib_path`` and return what nvcc
    printed. Raises when any step fails."""
    out_dir = os.path.dirname(lib_path)
    os.makedirs(out_dir, exist_ok=True)
    tag = os.getpid()
    nvcc = _nvcc()
    objs = [os.path.join(out_dir, f"{os.path.basename(c)}.{tag}.o") for c in cu]
    log = _run([
        (os.path.basename(c), subprocess.Popen(
            [nvcc, *NVCC_FLAGS, f"-I{CSRC}", "-c", "-o", o, c],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
        for c, o in zip(cu, objs)
    ])
    tmp = f"{lib_path}.{tag}.tmp"
    log += _run([("link", subprocess.Popen(
        [nvcc, *ARCH, "-shared", "-o", tmp, *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    ))])
    for o in objs:
        os.remove(o)
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees old or new
    return log


def open_library(lib_path: str) -> ctypes.CDLL:
    """Load a library that :func:`compile_library` built from the sources
    of ``csrc`` (or from copies of them) and declare its C entries."""
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in _ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.qasr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.qasr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> ctypes.CDLL:
    """Build (if stale) and load the kernel library; raises on any failure."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        cu, deps = sources()
        if not cu:
            raise RuntimeError(f"no CUDA sources under {CSRC}")
        if _stale(deps):
            t0 = time.perf_counter()
            build_log = compile_library(cu, LIB_PATH)
            build_seconds = time.perf_counter() - t0
        _lib = open_library(LIB_PATH)
        return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a kernel entry returned a CUDA error."""
    if err != 0:
        msg = lib.qasr_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
