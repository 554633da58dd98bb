"""Quaternion-aware weight initialization — the paper's recipe, in PyTorch.

Counterpart of ``qasr/ops/initializers.py`` (same distribution; the numbers
differ because ``torch.Generator`` is not JAX's PRNG):

  sigma  = 1/sqrt(2*(fan_in+fan_out))   (glorot)   or   1/sqrt(2*fan_in)   (he)
  |w|   ~ Chi(4 dof) at scale sigma     (norm of a 4-D N(0, sigma^2 I) draw)
  u      = random unit pure-imaginary quaternion (uniform on S^2)
  theta ~ U(-pi, pi)
  w      = |w| (cos theta + u sin theta)

fan_in/fan_out are counted in quaternion units (Cin*prod(kernel),
Cout*prod(kernel)).
"""

from __future__ import annotations

import math

import torch


def _fans(per_comp: tuple[int, ...]) -> tuple[int, int]:
    if len(per_comp) < 2:
        raise ValueError(f"need at least [Cin, Cout], got {per_comp}")
    receptive = math.prod(per_comp[:-2])
    return per_comp[-2] * receptive, per_comp[-1] * receptive


def quaternion_init(
    shape: tuple[int, ...],
    *,
    generator: torch.Generator | None = None,
    criterion: str = "glorot",
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """Draw stacked quaternion weights ``[4, *kernel, Cin, Cout]``.

    The draw runs on ``generator``'s device (CPU by default) and the result
    is moved to ``device``.
    """
    shape = tuple(shape)
    if shape[0] != 4:
        raise ValueError(f"stacked quaternion shape must lead with 4, got {shape}")
    per_comp = shape[1:]
    fan_in, fan_out = _fans(per_comp)
    if criterion == "glorot":
        sigma = 1.0 / math.sqrt(2.0 * (fan_in + fan_out))
    elif criterion == "he":
        sigma = 1.0 / math.sqrt(2.0 * fan_in)
    else:
        raise ValueError(f"unknown criterion {criterion!r}")
    gdev = generator.device if generator is not None else torch.device("cpu")
    kw = dict(generator=generator, device=gdev, dtype=torch.float32)
    mag = sigma * torch.linalg.vector_norm(torch.randn(*per_comp, 4, **kw), dim=-1)
    axis = torch.randn(*per_comp, 3, **kw)
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True).clamp_min(1e-12)
    theta = (torch.rand(*per_comp, **kw) * 2.0 - 1.0) * math.pi
    w_r = mag * torch.cos(theta)
    sin_t = mag * torch.sin(theta)
    w = torch.stack([w_r, sin_t * axis[..., 0], sin_t * axis[..., 1], sin_t * axis[..., 2]])
    return w.to(device=device, dtype=dtype)
