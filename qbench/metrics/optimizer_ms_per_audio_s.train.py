"""Device milliseconds a second of audio trained spend in the optimizer: the
global norm, the clip and AdamW (``train/step.py:apply_gradients``): the
device time of the kernels launched under the program's ``qasr.optimizer``
span (``qasr_torch.utils.profiling.SPANS``), over the real audio seconds of
the traced run's profiled steps. The span is the program's own: the traced
run wraps nothing for it."""

from qbench.spans import span_ms_per_audio_s

OPS = ("qasr.optimizer",)


def read(ctx):
    return span_ms_per_audio_s(ctx, OPS)
