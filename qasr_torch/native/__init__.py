"""Native (C++) host components, built with g++ at first use and loaded via
ctypes: the batch edit-distance / PER scorer (``edit_distance.cpp``), the
host-side CTC prefix beam search (``beam_decode.cpp``) and the FLAC decoder
(``flac_decode.cpp``).

The sources are the port's own copies of ``qasr/native/*.cpp`` (a test holds
their outputs to the reference's). The library is built into
``qasr_torch/_build/`` (git-ignored) and rebuilt when a source is newer; a
failure to build raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = [
    os.path.join(_DIR, "edit_distance.cpp"),
    os.path.join(_DIR, "beam_decode.cpp"),
    os.path.join(_DIR, "flac_decode.cpp"),
]
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libqasr_native.so")
_lock = threading.Lock()
_lib = None

_I32P = ctypes.POINTER(ctypes.c_int32)
_SIGNATURES = {
    "qasr_edit_distance": (ctypes.c_int, [_I32P, ctypes.c_int, _I32P, ctypes.c_int]),
    "qasr_batch_per": (
        None,
        [_I32P, _I32P, _I32P, _I32P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)],
    ),
    "qasr_flac_error": (ctypes.c_char_p, []),
    "qasr_flac_probe": (
        ctypes.c_int,
        [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), _I32P, _I32P, _I32P],
    ),
    "qasr_flac_decode": (ctypes.c_int64, [ctypes.c_char_p, _I32P, ctypes.c_int64]),
    "qasr_ctc_beam_decode": (
        None,
        [ctypes.POINTER(ctypes.c_float), _I32P] + [ctypes.c_int] * 6
        + [ctypes.c_float, _I32P, _I32P, ctypes.POINTER(ctypes.c_float)],
    ),
}


def _build() -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    proc = subprocess.run(
        ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", *_SRCS, "-o", tmp],
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, LIB_PATH)  # atomic: a concurrent loader sees old or new


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(LIB_PATH) or any(
            os.path.getmtime(LIB_PATH) < os.path.getmtime(src) for src in _SRCS
        ):
            _build()
        lib = ctypes.CDLL(LIB_PATH)
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return lib


def _as_i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _ptr(a: np.ndarray, ctype=ctypes.c_int32):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def edit_distance_native(ref, hyp) -> int:
    """Levenshtein distance of two integer sequences."""
    r, h = _as_i32(ref), _as_i32(hyp)
    return int(_load().qasr_edit_distance(_ptr(r), len(r), _ptr(h), len(h)))


def ctc_beam_decode_native(
    logits,
    lengths,
    *,
    beam_width: int = 16,
    blank_id: int = 0,
    max_len: int = 128,
    prune_logp: float | None = None,
):
    """Host-side CTC prefix beam search on CPU threads.

    Args:
      logits: ``[B, T, V]`` raw scores (log-softmax applied internally).
      lengths: ``[B]`` valid frame counts.

    Returns:
      (sequences ``[B, max_len]`` int32 padded with -1, lengths ``[B]`` int32,
       best-prefix log-score ``[B]`` float32).
    """
    lib = _load()
    logits = np.ascontiguousarray(logits, dtype=np.float32)
    lengths = _as_i32(lengths)
    b, t, v = logits.shape
    if v >= (1 << 20):
        raise ValueError("vocab must fit the 20-bit candidate key")
    out_seqs = np.empty((b, max_len), np.int32)
    out_lens = np.empty((b,), np.int32)
    out_scores = np.empty((b,), np.float32)
    lib.qasr_ctc_beam_decode(
        _ptr(logits, ctypes.c_float), _ptr(lengths), b, t, v, beam_width, blank_id, max_len,
        ctypes.c_float(-3e38 if prune_logp is None else prune_logp),
        _ptr(out_seqs), _ptr(out_lens), _ptr(out_scores, ctypes.c_float),
    )
    return out_seqs, out_lens, out_scores


def flac_probe(path: str) -> dict:
    """STREAMINFO of a FLAC file: n_samples / channels / sample_rate / bps."""
    lib = _load()
    n = ctypes.c_int64()
    ch, sr, bps = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    rc = lib.qasr_flac_probe(
        path.encode(), ctypes.byref(n), ctypes.byref(ch), ctypes.byref(sr), ctypes.byref(bps)
    )
    if rc != 0:
        raise ValueError(f"{path}: {lib.qasr_flac_error().decode()}")
    return {"n_samples": n.value, "channels": ch.value, "sample_rate": sr.value,
            "bps": bps.value}


def flac_decode_native(path: str) -> tuple[np.ndarray, int]:
    """Decode a FLAC file -> (samples ``[n, channels]`` int32 at the stream's
    bit depth, sample_rate)."""
    lib = _load()
    info = flac_probe(path)
    if info["n_samples"] > 0:
        cap = info["n_samples"] * info["channels"]
    else:
        # total unknown: compressed FLAC never drops below ~1 bit per sample
        cap = max(os.path.getsize(path) * 8, 4096)
    out = np.empty((cap,), np.int32)
    got = lib.qasr_flac_decode(path.encode(), _ptr(out), cap)
    if got < 0:
        raise ValueError(f"{path}: {lib.qasr_flac_error().decode()}")
    return out[: got * info["channels"]].reshape(-1, info["channels"]), info["sample_rate"]


def batch_per_native(refs, ref_lens, hyps, hyp_lens) -> tuple[int, int]:
    """Padded id matrices -> (total errors, total reference tokens)."""
    lib = _load()
    refs, hyps = _as_i32(refs), _as_i32(hyps)
    ref_lens, hyp_lens = _as_i32(ref_lens), _as_i32(hyp_lens)
    errs, total = ctypes.c_int64(), ctypes.c_int64()
    lib.qasr_batch_per(
        _ptr(refs), _ptr(ref_lens), _ptr(hyps), _ptr(hyp_lens), refs.shape[0],
        refs.shape[1] if refs.ndim == 2 else 0, hyps.shape[1] if hyps.ndim == 2 else 0,
        ctypes.byref(errs), ctypes.byref(total),
    )
    return int(errs.value), int(total.value)
