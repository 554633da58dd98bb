"""The acoustic front end in plain float32, from its description: 25 ms
Hamming-windowed frames every 10 ms, the power spectrum of a 512-point FFT,
an HTK triangular mel filterbank (``mel = 2595 log10(1 + f / 700)``) from 0
to the Nyquist frequency, the log floored at 1e-10, three orders of
regression deltas over +-2 frames (edges clamped), and per-utterance mean
and variance normalisation (variance floor 1e-8). Output ``[T, n_mels, 4]``
(fbank, delta, delta-delta, third delta)."""

from __future__ import annotations

import math

import numpy as np
import torch

from qbench.reference.precision import round_to

WIN, HOP, NFFT = 400, 160, 512


def mel_matrix(n_mels: int, sample_rate: int) -> np.ndarray:
    """``[NFFT // 2 + 1, n_mels]`` triangular filters, in float64."""
    def to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    edges = to_hz(np.linspace(to_mel(0.0), to_mel(sample_rate / 2.0), n_mels + 2))
    freqs = np.arange(NFFT // 2 + 1) * sample_rate / NFFT
    out = np.zeros((NFFT // 2 + 1, n_mels))
    for m in range(n_mels):
        lo, mid, hi = edges[m], edges[m + 1], edges[m + 2]
        rise = (freqs - lo) / max(mid - lo, 1e-8)
        fall = (hi - freqs) / max(hi - mid, 1e-8)
        out[:, m] = np.clip(np.minimum(rise, fall), 0.0, None)
    return out


def _deltas(c: torch.Tensor) -> torch.Tensor:
    """Regression deltas of ``c [T, F]`` along time, N = 2, edges clamped."""
    t = c.shape[0]
    idx = torch.arange(t, device=c.device)
    out = torch.zeros_like(c)
    for k in (1, 2):
        out = out + k * (c[(idx + k).clamp(max=t - 1)] - c[(idx - k).clamp(min=0)])
    return out / 10.0


def featurize(wav, n_mels: int = 40, sample_rate: int = 16000, device="cpu",
              prec: str = "f32") -> torch.Tensor:
    """One waveform -> normalised features ``[T, n_mels, 4]`` f32;
    ``prec`` rounds the windowed frames before the transform (the
    control)."""
    x = torch.as_tensor(np.asarray(wav, np.float32)).to(device)
    t = 1 + (x.shape[0] - WIN) // HOP
    frames = x[: (t - 1) * HOP + WIN].unfold(0, WIN, HOP)
    n = torch.arange(WIN, device=device, dtype=torch.float64)
    window = (0.54 - 0.46 * torch.cos(2.0 * math.pi * n / (WIN - 1))).float()
    frames = round_to(frames * window, prec)
    power = torch.fft.rfft(frames, n=NFFT).abs().square()
    melm = torch.as_tensor(mel_matrix(n_mels, sample_rate), dtype=torch.float32, device=device)
    mel = round_to(power, prec) @ round_to(melm, prec)
    fbank = torch.log(mel.clamp_min(1e-10))
    d1 = _deltas(fbank)
    d2 = _deltas(d1)
    d3 = _deltas(d2)
    f = torch.cat([fbank, d1, d2, d3], dim=1)  # [T, 4 * n_mels]
    mean = f.mean(dim=0, keepdim=True)
    var = ((f - mean) ** 2).mean(dim=0, keepdim=True)
    f = (f - mean) / torch.sqrt(var + 1e-8)
    return f.reshape(t, 4, n_mels).transpose(1, 2).contiguous()
