"""Profiling, timing and numerics-debugging utilities (counterpart of
``qasr/utils/``)."""

from qasr_torch.utils.debug import checkify_fn, deterministic_mode, nan_debug
from qasr_torch.utils.profiling import (
    CHIPS,
    ChipSpec,
    conv_roofline,
    qconv_flops,
    steady_state_time,
    trace,
)

__all__ = [
    "checkify_fn",
    "deterministic_mode",
    "nan_debug",
    "CHIPS",
    "ChipSpec",
    "conv_roofline",
    "qconv_flops",
    "steady_state_time",
    "trace",
]
