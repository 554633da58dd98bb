"""Device milliseconds a second of audio trained spend in the encoders' dense
layers: ``QDense`` on kernel B, PReLU, dropout and the output layer
(``models/qcnn.py:ConvTowerEncoder._run_dense``), and their backward: the
device time of the kernels launched under the program's ``qasr.dense`` span
(``qasr_torch.utils.profiling.SPANS``), forward and backward, over the real
audio seconds of the traced run's profiled steps. The span is the program's
own: the traced run wraps nothing for it."""

from qbench.spans import span_ms_per_audio_s

OPS = ("qasr.dense",)


def read(ctx):
    return span_ms_per_audio_s(ctx, OPS)
