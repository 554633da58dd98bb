"""Device milliseconds a second of audio trained spend in the stacked
quaternion convs' weight gradient: in each stacked layer's backward
(``ops/kernels/qconv_chain.py:ChainLayerFn.backward``), kernel K (the
PReLU, the input and output combos, db), the P correlations on cuDNN's
wgrad and the U fold: the device time of the kernels launched under the
program's ``qasr.conv_dw`` span (``qasr_torch.utils.profiling.SPANS``),
which nests inside ``qasr.qconv``'s backward, over the real audio seconds of
the traced run's profiled steps. The span is the program's own: the traced
run wraps nothing for it, and a program without it reads nothing."""

from qbench.spans import span_ms_per_audio_s

OPS = ("qasr.conv_dw",)


def read(ctx):
    return span_ms_per_audio_s(ctx, OPS)
