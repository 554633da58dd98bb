"""Device milliseconds a second of audio trained spend in the biQLSTM layers:
``models/qlstm.py:QBiLSTM.forward`` (the input projection, the glue copies,
the recurrence on kernel D, the output) and its backward (kernel E, the dW
einsums, the projection's dx and dW): the device time of the kernels
launched under the program's ``qasr.bilstm`` span
(``qasr_torch.utils.profiling.SPANS``), forward and backward, over the real
audio seconds of the traced run's profiled steps. The span is the program's
own: the traced run wraps nothing for it."""

from qbench.spans import span_ms_per_audio_s

OPS = ("qasr.bilstm",)


def read(ctx):
    return span_ms_per_audio_s(ctx, OPS)
