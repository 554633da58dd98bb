"""Acoustic front-end on the device."""

from qasr_torch.features.frontend import FrontendConfig, featurize_waveform

__all__ = ["FrontendConfig", "featurize_waveform"]
