"""Model FLOP utilisation of the serving path (``infer.py:Transcriber``):
the model FLOPs of the real frames of every request in the window (the
forward; the 8-product rule of ``qbench/flops.py``), over the window's
host-clock seconds, over the H100's 989 TFLOP/s, in %. In a traced run the
window is the stretch before the profiled one."""

from qbench import flops, peaks


def read(ctx):
    w = ctx.window
    if not w["items"]:
        return None
    work = sum(flops.model_flops(ctx.shape, i["real_frames"], False) for i in w["items"])
    return 100.0 * work / w["seconds"] / peaks.BF16_FLOPS
