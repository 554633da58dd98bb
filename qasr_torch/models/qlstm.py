"""The QCNN-LSTM hybrid encoder (counterpart of ``qasr/models/qlstm.py``),
bidirectional, in eval and train mode.

The quaternion conv tower (shared with the QCNN), then ``lstm_layers``
bidirectional quaternion LSTM layers, quaternion dense layers with their
split PReLUs, and a real output layer -> framewise CTC logits. Gate
projections are Hamilton products; the gate nonlinearities and the cell and
hidden updates are split (component-wise), as in Parcollet et al.'s QLSTM.

Each :class:`QBiLSTM` runs both directions' input projections as one
quaternion GEMM over all ``B * T`` rows, then one recurrence over both
directions at once (the backward stream time-flipped, its outputs
un-flipped). Recurrences:

- ``"pallas8"``: :func:`qasr_torch.ops.kernels.qlstm_scan.qlstm_scan_fast8`,
  kernel D on a CUDA tensor (its plain version on the CPU or with
  ``plain=True``), with ``_fwd_xla``'s arithmetic: f32 within a step, the
  state carried in the compute dtype. Under grad it goes through
  ``QLstmScanFn``, whose backward is kernel E (or its plain version, with
  ``_bwd_xla``'s arithmetic) and the dW einsums;
- ``"fast8"``: the plain in-scan rank-8 loop of the JAX ``recurrent="fast8"``
  branch, which the model takes where kernel D does not apply; autograd
  differentiates it, as JAX differentiates its scan.

The input projections' backward is the block product's autograd (at
``B * T >= BLOCK_ROWS``) or ``QGemm8Fn`` (kernel B forward and dx) below.

Parameters keep the JAX names and shapes (``docs/checkpoint_layout.md``):
``qbilstm_<i>.fwd_cell.{wx [4, In, 4H], wh [4, H, 4H], bias [16H]}`` and the
same under ``bwd_cell``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from qasr_torch.models.layers import Dense, Dropout, PReLU, QDense
from qasr_torch.models.qcnn import ConvTowerEncoder
from qasr_torch.ops.initializers import quaternion_init
from qasr_torch.ops.kernels.qgemm8 import qdense_pallas8
from qasr_torch.ops.kernels.qlstm_scan import qlstm_scan_fast8
from qasr_torch.ops.qlinalg import qdense
from qasr_torch.ops.quaternion import O8, V8, combine_weights, device_table

# M = B * T from which the input projection takes the block product
# (``qlstm.py:62-63``, measured on the TPU). On the H100 the block product is
# the faster arm at every M from 2048 to 16384, forward and backward
# (PERF.md); the threshold stays the TPU's until a change measured end to
# end moves it.
BLOCK_ROWS = 8192


def qchannel_split(x: torch.Tensor, groups: int) -> tuple[torch.Tensor, ...]:
    """Split packed ``[..., 4*G*H]`` into G packed ``[..., 4*H]`` tensors,
    keeping the component-major layout."""
    *lead, c4 = x.shape
    h = c4 // 4 // groups
    x = x.reshape(*lead, 4, groups, h)
    return tuple(x[..., g, :].reshape(*lead, 4 * h) for g in range(groups))


def qchannel_concat(parts) -> torch.Tensor:
    """Concatenate packed quaternion tensors along the quaternion channels."""
    lead = parts[0].shape[:-1]
    return torch.cat([p.reshape(*lead, 4, -1) for p in parts], dim=-1).reshape(*lead, -1)


def _block_proj(x: torch.Tensor, w: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    del plain  # the block product has no kernel
    return qdense(x, w)


def input_proj_fn(name: str, rows: int):
    """The input projection ``(x [M, 4K], w [4, K, N], plain=) -> [M, 4N]``:
    ``"auto"`` takes the block product (``qdense``: one matmul on the
    Hamilton-expanded weight) at ``rows >= BLOCK_ROWS`` and the rank-8 GEMM
    (kernel B, ``qdense_pallas8``) below; ``"block"``, ``"fast8"`` and
    ``"pallas8"`` choose one (both rank-8 names are kernel B here)."""
    if name == "auto":
        name = "block" if rows >= BLOCK_ROWS else "fast8"
    if name == "block":
        return _block_proj
    if name in ("fast8", "pallas8"):
        return qdense_pallas8
    raise ValueError(f"unknown input projection {name!r}")


class QLSTMCell(nn.Module):
    """Parameters of one direction: the input projection ``wx [4, In, 4H]``
    and the recurrent one ``wh [4, H, 4H]`` for all four gates (glorot
    quaternion init), and ``bias [16H]`` (zeros)."""

    def __init__(
        self,
        cin: int,
        hidden: int,
        *,
        generator: torch.Generator | None = None,
        device: torch.device | str = "cuda",
    ):
        super().__init__()
        init = dict(generator=generator, criterion="glorot", device=device)
        self.wx = nn.Parameter(quaternion_init((4, cin, 4 * hidden), **init))
        self.wh = nn.Parameter(quaternion_init((4, hidden, 4 * hidden), **init))
        self.bias = nn.Parameter(torch.zeros(16 * hidden, device=device))


def _gate_update(z: torch.Tensor, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split gates on packed ``z [..., 16H]`` (groups i, f, o, g)."""
    zi, zf, zo, zg = qchannel_split(z, 4)
    c_new = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zg)
    return torch.sigmoid(zo) * torch.tanh(c_new), c_new


def qlstm_fast8_scan(
    xs: torch.Tensor, wc8: torch.Tensor, lengths: torch.Tensor | None = None
) -> torch.Tensor:
    """The plain in-scan rank-8 recurrence (``qlstm.py:233-289``): ``xs [T, 2,
    B, 16H]`` packed component-major (direction 1 time-flipped), ``wc8 [2, 8,
    H, 4H]``; returns ``hs [T, 2, B, 4H]`` in scan order. The combos and the
    gates run in the compute dtype, the products sum in f32, and the
    recombined projection is cast to the compute dtype before it meets
    ``xs``, as the JAX branch does."""
    t, d, b, c16 = xs.shape
    hid = c16 // 16
    dt = xs.dtype
    v8 = device_table(V8, dt, xs.device)
    o8 = device_table(O8, torch.float32, xs.device)
    wc = wc8.float()
    h = xs.new_zeros((d, b, 4 * hid))
    c = xs.new_zeros((d, b, 4 * hid))
    out = []
    for s in range(t):
        hc = torch.einsum("dbak,pa->dbpk", h.reshape(d, b, 4, hid), v8)
        prods = torch.einsum("dbpk,dpkn->dbpn", hc.float(), wc)
        proj = torch.einsum("dbpn,qp->dbqn", prods, o8).reshape(d, b, c16).to(dt)
        h_new, c_new = _gate_update(xs[s] + proj, c)
        if lengths is not None:
            # direction 1 walks the flipped stream: its frame is T-1-s
            active = torch.stack([s < lengths, (t - 1 - s) < lengths])[:d, :, None]
            h_new = torch.where(active, h_new, h)
            c_new = torch.where(active, c_new, c)
        h, c = h_new, c_new
        out.append(h)
    return torch.stack(out) if out else xs.new_zeros((0, d, b, 4 * hid))


class QBiLSTM(nn.Module):
    """Bidirectional quaternion LSTM, both directions in one recurrence.

    ``x [B, T, 4*In]`` -> ``[B, T, 4*2H]`` (forward then backward hidden
    channels, packed). ``lengths [B]`` freezes each direction's state
    outside the utterance, so padding never reaches the valid frames.
    """

    def __init__(
        self,
        cin: int,
        hidden: int,
        *,
        dtype: torch.dtype = torch.float32,
        input_proj: str = "auto",
        recurrent: str = "pallas8",
        generator: torch.Generator | None = None,
        device: torch.device | str = "cuda",
    ):
        super().__init__()
        if recurrent not in ("pallas8", "fast8"):
            raise NotImplementedError(
                f"recurrent={recurrent!r} is not ported yet (ROADMAP.md Queue 1 item 13)"
            )
        self.hidden = hidden
        self.dtype = dtype
        self.input_proj = input_proj
        self.recurrent = recurrent
        self.fwd_cell = QLSTMCell(cin, hidden, generator=generator, device=device)
        self.bwd_cell = QLSTMCell(cin, hidden, generator=generator, device=device)

    def forward(
        self, x: torch.Tensor, lengths: torch.Tensor | None = None, *, plain: bool = False
    ) -> torch.Tensor:
        b, t, cin4 = x.shape
        dt = self.dtype
        # both directions' input projections as one quaternion GEMM
        wx_cat = torch.cat([self.fwd_cell.wx, self.bwd_cell.wx], dim=-1).to(dt)
        proj = input_proj_fn(self.input_proj, b * t)
        z = proj(x.to(dt).reshape(b * t, cin4), wx_cat, plain=plain)
        zf, zb = qchannel_split(z, 2)
        zf = (zf + self.fwd_cell.bias.to(dt)).reshape(b, t, -1)
        zb = (zb + self.bwd_cell.bias.to(dt)).reshape(b, t, -1)
        # [T, 2, B, 16H], the backward stream time-flipped
        xs = torch.stack([zf.transpose(0, 1), zb.transpose(0, 1).flip(0)], dim=1)
        wc8 = torch.stack([combine_weights(self.fwd_cell.wh, dt),
                           combine_weights(self.bwd_cell.wh, dt)])  # [2, 8, H, 4H]
        if self.recurrent == "pallas8":
            hs = qlstm_scan_fast8(xs.contiguous(), wc8, lengths, plain=plain)
        else:
            hs = qlstm_fast8_scan(xs, wc8, lengths)
        fwd = hs[:, 0].transpose(0, 1)
        bwd = hs[:, 1].flip(0).transpose(0, 1)
        return qchannel_concat([fwd, bwd])


class QLSTMEncoder(ConvTowerEncoder):
    """Quaternion conv tower + bidirectional QLSTM layers -> framewise CTC
    logits ``[B, T, vocab]`` in f32.

    Submodules carry the JAX names (``qconv_<i>``, ``conv_prelu_<i>``,
    ``qbilstm_<i>``, ``qdense_<i>``, ``dense_prelu_<i>``, ``output``), so a
    JAX ``QLSTMEncoder`` tree bridges by name. Dropout follows each QBiLSTM
    and each dense PReLU; in train mode its masks come from the generator
    the caller passes (the train state's), and in eval mode it is the
    identity.
    """

    def __init__(
        self,
        *,
        n_feats: int,
        conv_features: Sequence[int] = (64, 64, 128, 128),
        dense_features: Sequence[int] = (256,),
        lstm_features: int = 256,
        lstm_layers: int = 3,
        vocab: int = 32,
        kernel_size: tuple[int, int] = (3, 3),
        pool_after: int = 1,
        pool_size: int = 3,
        dropout_rate: float = 0.3,
        dtype: torch.dtype = torch.float32,
        input_proj: str = "auto",
        recurrent: str = "pallas8",
        use_pallas: bool = False,
        generator: torch.Generator | None = None,
        device: torch.device | str = "cuda",
    ):
        super().__init__()
        self.dtype = dtype
        self.recurrent = recurrent
        common = dict(dtype=dtype, generator=generator, device=device)
        # the JAX encoder's tower runs its default "auto" routing, or every
        # layer packed under use_pallas (qasr/models/qlstm.py:329-341)
        k = self._build_tower(n_feats, conv_features, kernel_size, pool_after, pool_size,
                              use_pallas=use_pallas, **common)
        self.lstm_layers = lstm_layers
        for i in range(lstm_layers):
            self.add_module(f"qbilstm_{i}", QBiLSTM(
                k, lstm_features, input_proj=input_proj, recurrent=recurrent, **common))
            self.add_module(f"lstm_dropout_{i}", Dropout(dropout_rate))
            k = 2 * lstm_features
        self.n_dense = len(dense_features)
        dense_scheme = "fast10" if use_pallas else "fast8"
        for i, feats in enumerate(dense_features):
            self.add_module(f"qdense_{i}", QDense(k, feats, scheme=dense_scheme, **common))
            self.add_module(f"dense_prelu_{i}", PReLU(4 * feats, device=device))
            self.add_module(f"dense_dropout_{i}", Dropout(dropout_rate))
            k = feats
        self.output = Dense(4 * k, vocab, **common)

    def forward(
        self,
        x: torch.Tensor,
        *,
        lengths: torch.Tensor | None = None,
        plain: bool = False,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """``x [B, T, F, 4]`` -> logits ``[B, T, vocab]`` f32. ``lengths [B]``
        frame counts keep padding out of the recurrences. ``plain=True``
        runs every kernel's plain PyTorch version, on any device."""
        x = self._run_tower(x, plain)
        for i in range(self.lstm_layers):
            x = getattr(self, f"qbilstm_{i}")(x, lengths, plain=plain)
            x = getattr(self, f"lstm_dropout_{i}")(x, generator)
        for i in range(self.n_dense):
            x = getattr(self, f"dense_prelu_{i}")(getattr(self, f"qdense_{i}")(x, plain=plain))
            x = getattr(self, f"dense_dropout_{i}")(x, generator)
        return self.output(x).float()
