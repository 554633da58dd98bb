"""Device milliseconds a second of audio trained spend in CTC:
``train/step.py:loss_fn`` (the f32 log-softmax, the lattice, the
normalisation) and its backward: the device time of the kernels launched
under the program's ``qasr.ctc`` span
(``qasr_torch.utils.profiling.SPANS``), forward and backward, over the real
audio seconds of the traced run's profiled steps. The span is the program's
own: the traced run wraps nothing for it."""

from qbench.spans import span_ms_per_audio_s

OPS = ("qasr.ctc",)


def read(ctx):
    return span_ms_per_audio_s(ctx, OPS)
