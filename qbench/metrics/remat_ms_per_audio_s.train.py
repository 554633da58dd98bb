"""Device milliseconds a second of audio trained spend recomputing the conv
tower in the backward (``train.remat_convs``): each conv layer's checkpoint
segment (``qasr_torch/models/qcnn.py:segment``) run again when the backward
first needs its saved tensors, for a stacked layer kernel A with its
prologue and bias, inside that layer's ``qasr.qconv`` backward range. The
device time of the kernels launched under the program's ``qasr.remat`` span
(``qasr_torch.utils.profiling.SPANS``) over the real audio seconds of the
traced run's profiled steps. The span is the program's own: the traced run
wraps nothing for it, and a run without remat, or a program without the
span, reads nothing."""

from qbench.spans import span_ms_per_audio_s

OPS = ("qasr.remat",)


def read(ctx):
    return span_ms_per_audio_s(ctx, OPS)
