"""Roofline share of the QLSTM recurrence (``ops/kernels/qlstm_scan.py``:
kernel D), forward only: the least time the H100 could take for that work
at the profiled stretch's real frames (per pass the larger of its FLOPs, by
the 8-product rule, over 989 TFLOP/s and its bytes over 3.35 TB/s;
``qbench/flops.py``), over the device time of the kernels the stretch ran
there, in %.

The device time is what runs under the range the traced run opens around
``qasr_torch.models.qlstm.qlstm_scan_fast8``. The bound depends on the
cell's shapes alone, whichever kernel runs."""

from qbench import flops, peaks

RANGES = [("qasr_torch.models.qlstm", "qlstm_scan_fast8", "qbench.qlstm_recurrence")]
OPS = ()


def read(ctx):
    if ctx.trace is None:
        return None
    device = ctx.trace.device_s(ranges=[r[2] for r in RANGES], ops=OPS)
    frames = sum(i["real_frames"] for i in ctx.profiled["items"])
    if not device or not frames or not ctx.shape.lstm_layers:
        return None
    bound = flops.recurrence_least_seconds(ctx.shape, frames, False, peaks.BF16_FLOPS,
                       peaks.HBM_BYTES)
    return 100.0 * bound / device
