"""Acoustic front-end: log-mel FBANK + Δ, ΔΔ, ΔΔΔ quaternion features, on the
given device (counterpart of ``qasr/features/frontend.py``).

Framing is a strided view, the DFT is one matmul against precomputed
real/imag DFT matrices (Hamming window folded in), the mel projection a
second matmul, and the regression deltas a clamped gather along time. The
tables are the JAX package's numpy functions, copied verbatim.

Output layout: packed ``[B, T, 4*n_mels]`` component-major
``[fbank, Δ, ΔΔ, ΔΔΔ]``; ``featurize_waveform`` returns ``[T, n_mels, 4]``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class FrontendConfig:
    sample_rate: int = 16000
    win_length: int = 400        # 25 ms
    hop_length: int = 160        # 10 ms
    n_fft: int = 512
    n_mels: int = 40
    fmin: float = 0.0
    fmax: float | None = None    # default sr/2
    delta_window: int = 2        # regression delta half-window
    log_floor: float = 1e-10


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def mel_filterbank(cfg: FrontendConfig) -> np.ndarray:
    """HTK-style triangular mel filterbank matrix ``[n_fft//2+1, n_mels]``."""
    fmax = cfg.fmax if cfg.fmax is not None else cfg.sample_rate / 2
    n_bins = cfg.n_fft // 2 + 1
    mel_pts = np.linspace(hz_to_mel(cfg.fmin), hz_to_mel(fmax), cfg.n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    bin_freqs = np.arange(n_bins) * cfg.sample_rate / cfg.n_fft
    fb = np.zeros((n_bins, cfg.n_mels), dtype=np.float32)
    for m in range(cfg.n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (bin_freqs - lo) / max(ctr - lo, 1e-8)
        down = (hi - bin_freqs) / max(hi - ctr, 1e-8)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


def dft_matrices(cfg: FrontendConfig) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag DFT matrices ``[win_length, n_fft//2+1]`` with the Hamming
    window folded in."""
    n_bins = cfg.n_fft // 2 + 1
    window = np.hamming(cfg.win_length).astype(np.float32)
    n = np.arange(cfg.win_length)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = -2.0 * math.pi * n * k / cfg.n_fft
    return (
        (window[:, None] * np.cos(ang)).astype(np.float32),
        (window[:, None] * np.sin(ang)).astype(np.float32),
    )


def num_frames(n_samples: int, cfg: FrontendConfig) -> int:
    return max(0, 1 + (n_samples - cfg.win_length) // cfg.hop_length)


def log_mel_spectrogram(x: torch.Tensor, cfg: FrontendConfig = FrontendConfig()) -> torch.Tensor:
    """``[B, N]`` waveform -> ``[B, T, n_mels]`` log-mel FBANK (f32)."""
    x = x.float()
    t = num_frames(x.shape[-1], cfg)
    frames = x[..., : (t - 1) * cfg.hop_length + cfg.win_length].unfold(
        -1, cfg.win_length, cfg.hop_length
    )  # [B, T, W]
    re_m, im_m = (torch.as_tensor(m, device=x.device) for m in dft_matrices(cfg))
    re = frames @ re_m
    im = frames @ im_m
    power = re * re + im * im
    mel = power @ torch.as_tensor(mel_filterbank(cfg), device=x.device)
    return torch.log(torch.clamp_min(mel, cfg.log_floor))


def _delta_taps(n: int) -> np.ndarray:
    """Regression delta filter: d_t = sum_k k*(c_{t+k}-c_{t-k}) / (2*sum k^2)."""
    denom = 2.0 * sum(k * k for k in range(1, n + 1))
    return np.arange(-n, n + 1, dtype=np.float32) / denom


def delta(
    feat: torch.Tensor, n: int = 2, lengths: torch.Tensor | None = None
) -> torch.Tensor:
    """Regression deltas along time: ``[B, T, F] -> [B, T, F]``, edge-clamped;
    with ``lengths`` each utterance clamps at its own last valid frame."""
    b, t, f = feat.shape
    taps = torch.as_tensor(_delta_taps(n), device=feat.device)
    offs = torch.arange(-n, n + 1, device=feat.device)
    idx = (torch.arange(t, device=feat.device)[:, None] + offs[None, :]).clamp(0, t - 1)
    idx = idx[None].expand(b, t, 2 * n + 1)
    if lengths is not None:
        last = (lengths.to(feat.device) - 1).clamp_min(0)
        idx = torch.minimum(idx, last[:, None, None])
    windows = torch.gather(
        feat, 1, idx.reshape(b, t * (2 * n + 1))[..., None].expand(-1, -1, f)
    ).reshape(b, t, 2 * n + 1, f)
    return torch.einsum("btwf,w->btf", windows, taps)


def quaternion_features(
    x: torch.Tensor,
    cfg: FrontendConfig = FrontendConfig(),
    lengths: torch.Tensor | None = None,
) -> torch.Tensor:
    """``[B, N]`` waveform -> packed ``[B, T, 4*n_mels]`` quaternion features."""
    fbank = log_mel_spectrogram(x, cfg)
    d1 = delta(fbank, cfg.delta_window, lengths)
    d2 = delta(d1, cfg.delta_window, lengths)
    d3 = delta(d2, cfg.delta_window, lengths)
    return torch.cat([fbank, d1, d2, d3], dim=-1)


def normalize_features(feat: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Per-utterance mean/variance normalization over valid frames.

    feat: ``[B, T, F]``; lengths: ``[B]`` valid frame counts.
    """
    lengths = lengths.to(feat.device)
    mask = (torch.arange(feat.shape[1], device=feat.device)[None, :] < lengths[:, None])[..., None]
    cnt = lengths[:, None, None].to(feat.dtype).clamp_min(1.0)
    mean = torch.sum(feat * mask, dim=1, keepdim=True) / cnt
    var = torch.sum(((feat - mean) ** 2) * mask, dim=1, keepdim=True) / cnt
    out = (feat - mean) * torch.rsqrt(var + 1e-8)
    return torch.where(mask, out, torch.zeros((), dtype=out.dtype, device=out.device))


def featurize_waveform(
    wav, cfg: FrontendConfig = FrontendConfig(), *, device: torch.device | str = "cuda"
) -> torch.Tensor:
    """One ``[N]`` waveform (numpy or tensor) -> normalized ``[T, n_mels, 4]``
    f32 features on ``device`` (the GPU unless the caller asks for the CPU);
    per-utterance CMVN over the valid frames."""
    x = torch.as_tensor(np.asarray(wav, np.float32) if not torch.is_tensor(wav) else wav)
    x = x.to(device=device, dtype=torch.float32)
    t = num_frames(x.shape[-1], cfg)
    if t == 0:  # shorter than one window: no frames, as in the JAX front-end
        return torch.zeros((0, cfg.n_mels, 4), device=x.device)
    lengths = torch.tensor([t], device=x.device)
    feats = normalize_features(quaternion_features(x[None], cfg, lengths), lengths)
    return feats[0].reshape(t, 4, cfg.n_mels).transpose(1, 2).contiguous()
