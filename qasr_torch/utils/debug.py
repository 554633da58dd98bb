"""Numerics debugging hooks (counterpart of ``qasr/utils/debug.py``).

The JAX package traps NaNs with ``jax_debug_nans``, surfaces float errors as
values with ``checkify`` and sets deterministic reductions for reproducible
runs. The PyTorch equivalents: a function mode that checks every forward
op's output plus autograd's anomaly mode for the backward, a wrapper that
returns an error value beside the output, and PyTorch's deterministic
algorithms.
"""

from __future__ import annotations

import contextlib
import functools
import os

import torch
from torch.overrides import TorchFunctionMode

_CUBLAS_WORKSPACE = ":4096:8"


def _tensors(out):
    """The tensors in ``out`` (a tensor or nested tuples and lists)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


def _non_finite(t: torch.Tensor) -> bool:
    return (t.is_floating_point() or t.is_complex()) and not bool(torch.isfinite(t).all())


class _RaiseOnNonFinite(TorchFunctionMode):
    """Checks the output of every torch function called in the mode (the
    checks themselves run outside it) and raises at the first non-finite
    value."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if any(_non_finite(t) for t in _tensors(out)):
            name = getattr(func, "__qualname__", None) or getattr(func, "__name__", repr(func))
            raise FloatingPointError(f"non-finite value (nan or inf) in the output of {name}")
        return out


@contextlib.contextmanager
def nan_debug():
    """Raise on the first non-finite value an op produces (slow; debugging
    only): a forward op's output raises ``FloatingPointError``; a backward
    function that returns NaN raises ``RuntimeError`` from autograd's anomaly
    mode, with the forward traceback of the op that made it. Every check
    reads the value back, so each op waits for the device."""
    with _RaiseOnNonFinite(), torch.autograd.set_detect_anomaly(True):
        yield


class CheckError:
    """What :func:`checkify_fn` found: ``get()`` gives the message or None;
    ``throw()`` raises ``FloatingPointError`` when there is one."""

    def __init__(self, msg: str | None = None):
        self.msg = msg

    def get(self) -> str | None:
        return self.msg

    def throw(self) -> None:
        if self.msg is not None:
            raise FloatingPointError(self.msg)


def checkify_fn(fn):
    """Wrap ``fn`` so that non-finite outputs surface as values.

    Returns ``wrapped(*args, **kwargs) -> (error, out)``; ``error.throw()``
    raises when a floating tensor of ``out`` holds a nan or an inf. (An
    out-of-bounds index, which the JAX package's checkify also catches,
    raises in PyTorch at the op itself.)
    """

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        bad = [i for i, t in enumerate(_tensors(out)) if _non_finite(t)]
        name = getattr(fn, "__qualname__", repr(fn))
        msg = f"non-finite value (nan or inf) in output tensor(s) {bad} of {name}" if bad else None
        return CheckError(msg), out

    return wrapped


def deterministic_mode() -> dict:
    """Settings for bitwise-reproducible runs: PyTorch's deterministic
    algorithms (an op that has none raises), cuBLAS's fixed workspace (read
    when cuBLAS starts, so call this before the first GEMM on the card) and
    cuDNN without autotuning. Returns the settings."""
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = _CUBLAS_WORKSPACE
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False
    return {
        "use_deterministic_algorithms": True,
        "CUBLAS_WORKSPACE_CONFIG": _CUBLAS_WORKSPACE,
        "cudnn.benchmark": False,
    }
