"""Device milliseconds a second of audio trained spend in the stacked
quaternion convs: each post-pool layer's ``chain_layer`` call from
``models/layers.py:QConv.forward`` (kernel A) and its backward (kernel C,
the dW convs, db): the device time of the kernels launched under the
program's ``qasr.qconv`` span (``qasr_torch.utils.profiling.SPANS``),
forward and backward, over the real audio seconds of the traced run's
profiled steps. The span is the program's own: the traced run wraps nothing
for it."""

from qbench.spans import span_ms_per_audio_s

OPS = ("qasr.qconv",)


def read(ctx):
    return span_ms_per_audio_s(ctx, OPS)
