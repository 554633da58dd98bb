"""Tracing, timing and roofline utilities (counterpart of
``qasr/utils/profiling.py``).

* :func:`trace` wraps ``torch.profiler`` and writes a Chrome trace;
* :func:`span` and :func:`traced` open the port's own ranges (:data:`SPANS`)
  on the profiler's clock, at each layer of the train step and the serving
  path, forward and backward; with no profiler recording they cost one flag
  check;
* :func:`steady_state_time` is the timing harness: the difference quotient
  of two chained run lengths, which cancels the fixed cost of starting and
  ending a run (here: the host's launch ramp and the final synchronise);
* :func:`conv_roofline` reports the quaternion conv's achieved FLOP/s
  against the card's peak and against the 4x-expanded real conv.

:data:`CHIPS` holds datasheet figures of the cards the port runs on.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
import warnings
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch._C._profiler import _RecordFunctionFast


@dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_bf16_tflops: float
    hbm_gbps: float


# NVIDIA's H100 SXM datasheet: dense bf16 on the tensor cores, HBM3
CHIPS = {
    "h100": ChipSpec("h100", 989.0, 3350.0),
}


def trace_supported() -> bool:
    """Whether :func:`trace` records device activity: a CUDA card is present."""
    return torch.cuda.is_available()


@contextlib.contextmanager
def trace(log_dir: str, *, force: bool = False):
    """Profile a region with ``torch.profiler`` (host and CUDA activity) into
    the Chrome trace ``log_dir/trace.json``.

    Without a CUDA card (see :func:`trace_supported`) this warns and records
    nothing; ``force=True`` records the host activity alone.
    """
    if not force and not trace_supported():
        warnings.warn(
            "no CUDA device to trace; trace() is a no-op here (force=True records the host alone)",
            stacklevel=3,
        )
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


#: every range the port opens. Readers match a range by ``name in
#: event.name``, so no name is a part of another.
SPANS = (
    "qasr.train_step",   # train/step.py:train_step and the sharded step
    "qasr.h2d",          # batch_to_device: the batch's host-to-device copies
    "qasr.forward",      # the model's call: train, eval and serving
    "qasr.backward",     # zero_grad and loss.backward()
    "qasr.optimizer",    # global norm, clip and AdamW (sharded: clip and AdamW)
    "qasr.ctc",          # loss_fn and its backward
    "qasr.qconv",        # a stacked layer's chain_layer and its backward
    "qasr.conv_dw",      # ChainLayerFn's dW and db: kernel K, cuDNN's wgrad, the U fold
    "qasr.remat",        # a checkpoint segment's recompute in the backward (train.remat_convs)
    "qasr.bilstm",       # QBiLSTM: projection, glue, recurrence; and its backward
    "qasr.qlstm_scan",   # QLstmScanFn: kernels D and E, the dW einsums
    "qasr.dense",        # the encoders' dense layers and output; and its backward
    "qasr.transcribe",   # Transcriber.transcribe_batch
    "qasr.frontend",     # Transcriber.logits: featurization and padding
    "qasr.decode",       # Transcriber.decode
)

_NULL = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` (one of :data:`SPANS`) while a
    profiler records, on the clock of the device activity it covers;
    otherwise a shared null context, after one flag check. The range is
    PyTorch's C++ ``RecordFunctionFast``, which costs the host about a tenth
    of what ``torch.profiler.record_function`` does."""
    if torch.autograd._profiler_enabled():
        return _RecordFunctionFast(name)
    return _NULL


class _Bracket:
    """A layer's backward range: :meth:`open` is a pre-hook on the node that
    receives the output's gradient, :meth:`close` a hook on the input's
    gradient. The engine runs a node's tensor hooks before its pre-hooks, so
    where one layer's input is the next one's output, the later layer's
    range closes before the earlier one's opens."""

    __slots__ = ("name", "rf")

    def __init__(self, name: str):
        self.name, self.rf = name, None

    def open(self, _grads) -> None:
        if self.rf is None:
            self.rf = _RecordFunctionFast(self.name)
            self.rf.__enter__()

    def close(self, _grad) -> None:
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None


def traced(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under :func:`span` ``(name)``, its backward
    under a range of the same name.

    While a profiler records, with grad enabled and a tensor argument that
    requires grad (the first such is the layer's input), two hooks bracket
    the layer's backward: one on the outputs' nodes opens the range when
    their gradients arrive, one on the input closes it when the input's
    gradient is done. The layer's parameters come out of the same nodes as
    its input's gradient. Hooks add no autograd node and change no value:
    the gradients are the same bits with or without a profiler. ``fn``
    returns a tensor or a tuple of tensors (and non-tensors)."""
    if not torch.autograd._profiler_enabled():
        return fn(*args, **kwargs)
    with _RecordFunctionFast(name):
        out = fn(*args, **kwargs)
    x = next((a for a in args if isinstance(a, torch.Tensor) and a.requires_grad), None)
    if x is None or not torch.is_grad_enabled():
        return out
    bracket = _Bracket(name)
    x.register_hook(bracket.close)
    for o in (out,) if isinstance(out, torch.Tensor) else out:
        if isinstance(o, torch.Tensor) and o.grad_fn is not None:
            o.grad_fn.register_prehook(bracket.open)
    return out


def steady_state_times(runs: dict, *, n_small=5, n_big=25, repeats=3) -> dict:
    """Interleaved difference-quotient seconds/step for several arms.

    ``runs`` maps name -> run_chained(n) -> wall seconds, or name ->
    (run_chained, (n_small, n_big)) for per-arm chain lengths. Arms are
    interleaved ABAB across repeats (shedding drift between them) and
    per-arm medians are returned.
    """
    norm = {
        k: (v if isinstance(v, tuple) else (v, (n_small, n_big)))
        for k, v in runs.items()
    }
    est = {k: [] for k in runs}
    for _ in range(repeats):
        for name, (run, (ns, nb)) in norm.items():
            t_small = run(ns)
            t_big = run(nb)
            est[name].append((t_big - t_small) / (nb - ns))
    return {k: statistics.median(v) for k, v in est.items()}


def steady_state_time(run_chained, *, n_small=5, n_big=25, repeats=3) -> float:
    """Difference-quotient seconds/step for `run_chained(n) -> wall seconds`."""
    return steady_state_times(
        {"arm": run_chained}, n_small=n_small, n_big=n_big, repeats=repeats
    )["arm"]


def qconv_flops(batch, t, f, cin, cout, kh=3, kw=3) -> int:
    """Matrix-unit FLOPs of one quaternion conv fwd at SAME padding (16
    block products == the 4x-expanded real conv's FLOPs; the reference's
    strategy, SURVEY.md §3.2)."""
    return 2 * batch * t * f * kh * kw * (4 * cin) * (4 * cout)


def conv_roofline(
    *,
    batch=16,
    t=256,
    f=13,
    cin=64,
    cout=64,
    dtype="bfloat16",
    chip="h100",
    use_pallas=False,
    variant="block",
    repeats=3,
    device="cuda",
) -> dict:
    """Measure achieved quaternion-conv FLOPs vs the card's peak.

    Returns a dict with achieved TFLOP/s, % of peak, and seconds/step for the
    quaternion path and the explicitly 4x-expanded real conv baseline (one
    cuDNN conv). ``variant="block"`` runs :func:`qasr_torch.ops.qlinalg.qconv`
    (cuDNN on the expanded weight), ``"fast"`` and ``"fast10"`` the packed
    10-product arms ``qconv_fast`` and ``qconv_fast10``; ``use_pallas=True`` runs
    :func:`qasr_torch.ops.kernels.qgemm.qconv2d_pallas` (slice-im2col and
    kernel H on a CUDA tensor). FLOPs are always counted as the 16-product
    equivalent (the reference's per-step computation). ``device="cpu"``
    runs the plain versions on the host: its times are the host's, never a
    device metric.
    """
    from qasr_torch.ops.kernels.qgemm import qconv2d_pallas
    from qasr_torch.ops.qlinalg import qconv, qconv_fast, qconv_fast10
    from qasr_torch.ops.quaternion import hamilton_expand

    paths = {"block": qconv, "fast": qconv_fast, "fast10": qconv_fast10}
    if variant not in paths:
        raise ValueError(f"unknown variant {variant!r} (choose block | fast | fast10)")
    if cin != cout:
        raise ValueError("the roofline harness chains outputs; it needs cin == cout")
    dev = torch.device(device)
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((batch, t, f, 4 * cin), generator=g, device=dev).to(dt)
    w = torch.randn((4, 3, 3, cin, cout), generator=g, device=dev).to(dt)
    w_real = hamilton_expand(w).to(dt).permute(3, 2, 0, 1).contiguous()  # OIHW

    q_fn = qconv2d_pallas if use_pallas else paths[variant]

    def real_fn(c, wr):
        # NHWC in and out, as the quaternion path's layout
        return F.conv2d(c.permute(0, 3, 1, 2), wr, padding="same").permute(0, 2, 3, 1)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def make_chain(fn, *args):
        # n chained convs, RMS-normalised between them so that bf16 values
        # stay finite along the chain. PyTorch returns before the device
        # finishes; on CUDA one synchronize() at the end of the chain is a
        # true sync, so the chain's wall time is its device time plus a
        # fixed cost, which the difference quotient cancels.
        @torch.no_grad()
        def chain(n):
            c = args[0]
            for _ in range(n):
                y = fn(c, *args[1:])
                scale = torch.rsqrt(y.float().square().mean() + 1e-6).to(y.dtype)
                c = y * scale
            return c.float().sum()

        def run(n):
            chain(n)  # warm
            sync()
            t0 = time.perf_counter()
            v = chain(n)
            sync()
            dt_run = time.perf_counter() - t0
            if not torch.isfinite(v):
                raise RuntimeError("non-finite chain output")
            return dt_run

        return run

    t_q = steady_state_time(
        make_chain(lambda c, ww: q_fn(c, ww), x, w),
        n_small=10, n_big=60, repeats=repeats,
    )
    t_r = steady_state_time(
        make_chain(real_fn, x, w_real),
        n_small=10, n_big=60, repeats=repeats,
    )

    flops = qconv_flops(batch, t, f, cin, cout)
    spec = CHIPS[chip]
    achieved_q = flops / t_q / 1e12
    achieved_r = flops / t_r / 1e12
    return {
        "flops_per_step": flops,
        "qconv_s": t_q,
        "expanded_real_s": t_r,
        "qconv_tflops": achieved_q,
        "expanded_real_tflops": achieved_r,
        "qconv_pct_of_peak": 100 * achieved_q / spec.peak_bf16_tflops,
        "qconv_vs_expanded_real": t_r / t_q,
        "variant": "pallas" if use_pallas else variant,
        "chip": chip,
    }
