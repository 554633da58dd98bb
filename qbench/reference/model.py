"""Plain float32 reference of the two encoders the benchmark runs, written
from the models' description and not from the program's code.

- QCNN (Parcollet et al. 2018, arXiv:1806.07789): quaternion 3x3 convs over
  (time, frequency), each followed by a split PReLU, a (1, pool) VALID max
  pool over frequency after ``pool_after`` layers, the flatten to ``F * C``
  quaternion channels a frame, quaternion dense layers with split PReLUs and
  inverted dropout, and a real output layer: framewise CTC logits.
- QCNN-biQLSTM (the repo's hybrid; the QLSTM cell of Parcollet et al. 2019,
  arXiv:1811.02566): the same conv tower, then bidirectional quaternion LSTM
  layers (Hamilton-product gate projections, split gates i, f, o, g, the
  state frozen outside each utterance's frames), dropout after each, then
  the dense layers and the output layer.

A quaternion product ``y = w ⊗ x`` is computed as one real product with the
4x-expanded real matrix, built here from the basis products of the
quaternion units. Activations are packed component-major ``[..., 4*C]``
(``r`` channels, then ``i``, ``j``, ``k``). Parameters are named and shaped
as the program's checkpoint layout (``kernel [4, kh, kw, Cin, Cout]``,
``kernel [4, K, N]``, ``bias [4*N]``, ``alpha [4*C]``, an LSTM cell's ``wx
[4, In, 4H]``, ``wh [4, H, 4H]``, ``bias [16H]``), so one dict of weights
serves both sides. Every product goes through :func:`precision.q`, so the
same code in a lower precision is the control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from qbench.reference.precision import q, round_to

# e_c * e_a = SIGN * e_OUT for the quaternion units 1, i, j, k (index 0..3)
_UNIT_PRODUCT = {
    (0, 0): (1, 0), (0, 1): (1, 1), (0, 2): (1, 2), (0, 3): (1, 3),
    (1, 0): (1, 1), (1, 1): (-1, 0), (1, 2): (1, 3), (1, 3): (-1, 2),
    (2, 0): (1, 2), (2, 1): (-1, 3), (2, 2): (-1, 0), (2, 3): (1, 1),
    (3, 0): (1, 3), (3, 1): (1, 2), (3, 2): (-1, 1), (3, 3): (-1, 0),
}


def expand(w: torch.Tensor) -> torch.Tensor:
    """``w [4, *taps, Cin, Cout]`` -> the real matrix ``[*taps, 4*Cin,
    4*Cout]`` of ``x -> w ⊗ x`` on packed input: block ``(a, b)`` holds
    ``sign * w[c]`` where ``e_c e_a = sign * e_b``."""
    lead = w.shape[1:-2]
    cin, cout = w.shape[-2], w.shape[-1]
    blocks = [[None] * 4 for _ in range(4)]
    for (c, a), (sign, b) in _UNIT_PRODUCT.items():
        blocks[a][b] = w[c] if sign > 0 else -w[c]
    rows = [torch.cat(blocks[a], dim=-1) for a in range(4)]  # each [*taps, Cin, 4Cout]
    out = torch.cat(rows, dim=-2)
    return out.reshape(*lead, 4 * cin, 4 * cout)


def qdense(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    """Quaternion dense ``[..., 4K] -> [..., 4N]``."""
    return q(x, prec) @ q(expand(w), prec)


def qconv(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    """SAME quaternion conv of packed ``x [B, T, F, 4*Cin]`` by ``w [4, kh,
    kw, Cin, Cout]`` (kh over time, kw over frequency) -> ``[B, T, F,
    4*Cout]``."""
    wr = expand(w)  # [kh, kw, 4Cin, 4Cout]
    kh, kw = wr.shape[0], wr.shape[1]
    y = F.conv2d(q(x, prec).permute(0, 3, 1, 2), q(wr.permute(3, 2, 0, 1), prec),
                 padding=(kh // 2, kw // 2))
    return y.permute(0, 2, 3, 1)


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Split PReLU: one slope a real channel."""
    return torch.where(x >= 0, x, alpha * x)


def freq_pool(x: torch.Tensor, size: int) -> torch.Tensor:
    """``[B, T, F, C]`` max over non-overlapping windows of ``size`` bins."""
    b, t, f, c = x.shape
    fo = (f - size) // size + 1
    return x[:, :, : fo * size].reshape(b, t, fo, size, c).amax(dim=3)


def flatten(x: torch.Tensor) -> torch.Tensor:
    """``[B, T, F, 4C]`` -> ``[B, T, 4*(F*C)]``, component-major."""
    b, t, f, c4 = x.shape
    return x.reshape(b, t, f, 4, c4 // 4).transpose(2, 3).reshape(b, t, f * c4)


# -- parameters ----------------------------------------------------------------


def tower_out(model: dict, n_mels: int) -> int:
    f = n_mels
    for i in range(len(model["conv_features"])):
        if i + 1 == model["pool_after"]:
            f = (f - model["pool_size"]) // model["pool_size"] + 1
    return f * model["conv_features"][-1]


def param_specs(model: dict, n_mels: int) -> list[tuple[str, tuple, str]]:
    """``(name, shape, kind)`` of every parameter, in a fixed order; kind is
    ``"qkernel"``, ``"kernel"``, ``"bias"`` or ``"alpha"``."""
    kh, kw = model["kernel_size"]
    specs = []
    cin = 1
    for i, feats in enumerate(model["conv_features"]):
        specs += [(f"qconv_{i}.kernel", (4, kh, kw, cin, feats), "qkernel"),
                  (f"qconv_{i}.bias", (4 * feats,), "bias"),
                  (f"conv_prelu_{i}.alpha", (4 * feats,), "alpha")]
        cin = feats
    k = tower_out(model, n_mels)
    if model["arch"] == "qlstm":
        hid = model["lstm_features"]
        for i in range(model["lstm_layers"]):
            for d in ("fwd_cell", "bwd_cell"):
                specs += [(f"qbilstm_{i}.{d}.wx", (4, k, 4 * hid), "qkernel"),
                          (f"qbilstm_{i}.{d}.wh", (4, hid, 4 * hid), "qkernel"),
                          (f"qbilstm_{i}.{d}.bias", (16 * hid,), "bias")]
            k = 2 * hid
    elif model["arch"] != "qcnn":
        raise ValueError(f"no reference for arch {model['arch']!r}")
    for i, feats in enumerate(model["dense_features"]):
        specs += [(f"qdense_{i}.kernel", (4, k, feats), "qkernel"),
                  (f"qdense_{i}.bias", (4 * feats,), "bias"),
                  (f"dense_prelu_{i}.alpha", (4 * feats,), "alpha")]
        k = feats
    specs += [("output.kernel", (4 * k, model["vocab"]), "kernel"),
              ("output.bias", (model["vocab"],), "bias")]
    return specs


def make_params(model: dict, n_mels: int, seed: int, device) -> dict[str, torch.Tensor]:
    """Seeded f32 weights on ``device`` from one generator on that device and
    one draw of normals: each kernel with standard deviation ``gain /
    sqrt(real fan-in)`` (a quaternion kernel's fan-in is 4 * Cin * taps; the
    gain 1.3 keeps the variance through the split PReLUs), biases 0.1, PReLU
    slopes 0.25 + 0.05 N(0, 1)."""
    specs = param_specs(model, n_mels)
    total = sum(math.prod(s) for _, s, _ in specs)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device)
    out, off = {}, 0
    for name, shape, kind in specs:
        n = math.prod(shape)
        z = flat[off:off + n].reshape(shape)
        off += n
        if kind == "qkernel":
            fan_in = 4 * math.prod(shape[1:-1])
            out[name] = z * (1.3 / math.sqrt(fan_in))
        elif kind == "kernel":
            out[name] = z * (1.0 / math.sqrt(shape[0]))
        elif kind == "bias":
            out[name] = z * 0.1
        else:
            out[name] = 0.25 + 0.05 * z
    return out


# -- forward -------------------------------------------------------------------


class Masks:
    """The dropout masks of one train forward, drawn in the program's order
    of dropout layers from its generator: each layer draws ``torch.rand``
    of its input's shape and keeps an element where the draw is below ``1 -
    rate`` (inverted dropout, scaled by ``1 / (1 - rate)``). Drawn whole up
    front, so that the forward can then run in blocks of rows."""

    def __init__(self, model: dict, b: int, t: int, generator: torch.Generator, device):
        keep = 1.0 - model["dropout_rate"]
        self.keep = keep
        widths = []
        if model["arch"] == "qlstm":
            widths += [4 * 2 * model["lstm_features"]] * model["lstm_layers"]
        widths += [4 * n for n in model["dense_features"]]
        self.masks = [torch.rand((b, t, w), generator=generator, device=device) < keep
                      for w in widths] if model["dropout_rate"] > 0 else None

    def rows(self, lo: int, hi: int) -> list | None:
        return None if self.masks is None else [m[lo:hi] for m in self.masks]


def conv_tower(params: dict, model: dict, x: torch.Tensor, prec: str) -> torch.Tensor:
    """``x [B, T, F, 4]`` -> ``[B, T, 4*(F'*C)]``."""
    for i in range(len(model["conv_features"])):
        x = qconv(x, params[f"qconv_{i}.kernel"], prec) + params[f"qconv_{i}.bias"]
        x = prelu(x, params[f"conv_prelu_{i}.alpha"])
        if i + 1 == model["pool_after"]:
            x = freq_pool(x, model["pool_size"])
    return flatten(x)


def _gate_major(w: torch.Tensor, hid: int) -> torch.Tensor:
    """Columns of a packed ``[..., 16H]`` projection (component, gate, unit)
    reordered gate-major (gate, component, unit), so each gate is one
    contiguous ``[4H]`` block."""
    lead = w.shape[:-1]
    return w.reshape(*lead, 4, 4, hid).transpose(-3, -2).reshape(*lead, 16 * hid)


class _Recurrence(torch.autograd.Function):
    """Both directions' LSTM recurrence over the steps of ``xs [2, B, T,
    16H]`` (gate-major: i, f, o, g, each ``[4H]`` packed), recurrent
    weights ``wh [2, 4H, 16H]`` and ``active [T, 2, B, 1]`` (where the state
    steps); returns the hidden states ``[2, B, T, 4H]``. The backward runs
    the chain rule step by step in reverse (the gates kept from the
    forward), then the weight gradient as one product over all steps."""

    @staticmethod
    def forward(ctx, xs, wh, active, prec):
        d, b, t, h16 = xs.shape
        h4 = h16 // 4
        h = xs.new_zeros((d, b, h4))
        c = xs.new_zeros((d, b, h4))
        gates = xs.new_empty((t, d, b, h16))
        cs = xs.new_empty((t, d, b, h4))
        hs = xs.new_empty((t, d, b, h4))
        for s in range(t):
            pre = torch.baddbmm(xs[:, :, s], round_to(h, prec), wh)
            gs = gates[s]
            torch.sigmoid(pre[..., : 3 * h4], out=gs[..., : 3 * h4])
            torch.tanh(pre[..., 3 * h4:], out=gs[..., 3 * h4:])
            i, f, o, g = gs.split(h4, dim=-1)
            c_new = torch.addcmul(f * c, i, g)
            h_new = o * torch.tanh(c_new)
            c = torch.where(active[s], c_new, c)
            h = torch.where(active[s], h_new, h)
            cs[s] = c
            hs[s] = h
        ctx.prec = prec
        ctx.save_for_backward(wh, active, gates, cs, hs)
        return hs.permute(1, 2, 0, 3)

    @staticmethod
    def backward(ctx, dhs):
        wh, active, gates, cs, hs = ctx.saved_tensors
        t, d, b, h16 = gates.shape
        h4 = h16 // 4
        dhs = dhs.permute(2, 0, 1, 3)
        wht = wh.transpose(1, 2)
        dh = hs.new_zeros((d, b, h4))
        dc = hs.new_zeros((d, b, h4))
        dpre = torch.zeros_like(gates)
        for s in range(t - 1, -1, -1):
            dh = dh + dhs[s]
            i, f, o, g = gates[s].split(h4, dim=-1)
            c_prev = cs[s - 1] if s else torch.zeros_like(dc)
            tc = torch.tanh(cs[s])
            dct = dc + dh * o * (1 - tc * tc)
            dp = torch.cat([dct * g * i * (1 - i), dct * c_prev * f * (1 - f),
                            dh * tc * o * (1 - o), dct * i * (1 - g * g)], dim=-1)
            dp = torch.where(active[s], dp, torch.zeros_like(dp))
            dpre[s] = dp
            dh = torch.where(active[s], torch.bmm(round_to(dp, ctx.prec, grad=True), wht), dh)
            dc = torch.where(active[s], dct * f, dc)
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        dwh = torch.einsum("tdbk,tdbn->dkn", round_to(h_prev, ctx.prec),
                           round_to(dpre, ctx.prec, grad=True))
        return dpre.permute(1, 2, 0, 3), dwh, None, None


def bilstm(params: dict, prefix: str, x: torch.Tensor, lengths: torch.Tensor, hid: int,
           prec: str) -> torch.Tensor:
    """One bidirectional QLSTM layer: ``x [B, T, 4*In]`` -> ``[B, T,
    4*2H]`` (per component the forward then the backward units). The
    backward direction reads the frames last to first; each direction's
    state stays as it is on the frames past the utterance's length."""
    b, t, _ = x.shape
    zs, whs = [], []
    for d in ("fwd_cell", "bwd_cell"):
        z = qdense(x, params[f"{prefix}.{d}.wx"], prec) + params[f"{prefix}.{d}.bias"]
        zs.append(_gate_major(z, hid))
        whs.append(_gate_major(expand(params[f"{prefix}.{d}.wh"]), hid))
    xs = torch.stack([zs[0], zs[1].flip(1)], dim=0)  # [2, B, T, 16H]
    wh = q(torch.stack(whs), prec)  # [2, 4H, 16H]
    frame = torch.arange(t, device=x.device)
    lens = lengths.to(x.device)
    # active[s, d, b]: step s of direction d is a frame of row b
    active = torch.stack([frame[:, None] < lens[None], (t - 1 - frame)[:, None] < lens[None]],
                         dim=1)[..., None]
    hs = _Recurrence.apply(xs, wh, active, prec)  # [2, B, T, 4H]
    fwd = hs[0].reshape(b, t, 4, hid)
    bwd = hs[1].flip(1).reshape(b, t, 4, hid)
    return torch.cat([fwd, bwd], dim=-1).reshape(b, t, 8 * hid)


def forward(params: dict, model: dict, x: torch.Tensor, lengths: torch.Tensor, *,
            masks: list | None = None, keep: float = 1.0, prec: str = "f32",
            remat: bool = False) -> torch.Tensor:
    """Logits ``[B, T, vocab]`` f32 of features ``x [B, T, n_mels, 4]``;
    ``masks`` (this block's rows of :class:`Masks`) applies train-mode
    dropout. ``remat`` recomputes the conv tower in the backward instead of
    keeping its activations (the same gradients)."""

    def seg(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)

    x = seg(lambda v: conv_tower(params, model, v, prec), x.float())
    m = iter(masks) if masks is not None else None

    def drop(x):
        return x if m is None else torch.where(next(m), x / keep, torch.zeros_like(x))

    if model["arch"] == "qlstm":
        for i in range(model["lstm_layers"]):
            x = drop(bilstm(params, f"qbilstm_{i}", x, lengths, model["lstm_features"], prec))
    for i in range(len(model["dense_features"])):
        x = qdense(x, params[f"qdense_{i}.kernel"], prec) + params[f"qdense_{i}.bias"]
        x = drop(prelu(x, params[f"dense_prelu_{i}.alpha"]))
    return q(x, prec) @ q(params["output.kernel"], prec) + params["output.bias"]
