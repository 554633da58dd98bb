"""The QCNN-LSTM hybrid encoder and its real ablation (counterpart of
``qasr/models/qlstm.py``), in eval and train mode.

The quaternion conv tower (shared with the QCNN), then ``lstm_layers``
quaternion LSTM layers (bidirectional :class:`QBiLSTM`, or unidirectional
:class:`QLSTMLayer`), quaternion dense layers with their split PReLUs, and a
real output layer -> framewise CTC logits. Gate projections are Hamilton
products; the gate nonlinearities and the cell and hidden updates are split
(component-wise), as in Parcollet et al.'s QLSTM.

Each layer runs its input projection as one quaternion GEMM over all ``B *
T`` rows (:func:`input_proj_fn`: the block product, or kernel B), then one
recurrence (a :class:`QBiLSTM` over both directions at once, the backward
stream time-flipped and its outputs un-flipped). Recurrences:

- ``"pallas8"``: :func:`qasr_torch.ops.kernels.qlstm_scan.qlstm_scan_fast8`,
  kernel D on a CUDA tensor (its plain version on the CPU or with
  ``plain=True``), with ``_fwd_xla``'s arithmetic: f32 within a step, the
  state carried in the compute dtype. Under grad it goes through
  ``QLstmScanFn``, whose backward is kernel E (or its plain version, with
  ``_bwd_xla``'s arithmetic) and the dW einsums. Bidirectional only;
- ``"fast8"``: :func:`qlstm_fast8_scan`, the plain in-scan rank-8 loop of
  the JAX ``recurrent="fast8"`` branch, which the model takes where kernel D
  does not apply;
- ``"block"``: :func:`qlstm_block_scan`, the JAX reference strategy: the
  recurrent weights Hamilton-expanded once, one batched product a step in
  the compute dtype.

The JAX package runs the last two on XLA, so they are plain PyTorch loops
here, which autograd differentiates as JAX differentiates its scan.

:class:`RealLSTMEncoder` is config 4's equal-real-width ablation: real
convs (``RealCNNEncoder``'s), :class:`RealBiLSTM` layers of ``4 *
lstm_features`` real units, real dense layers; cuDNN convs and cuBLAS
products, no kernel of the port, as the JAX package runs it on plain XLA.

Parameters keep the JAX names and shapes (``docs/checkpoint_layout.md``):
``qbilstm_<i>.fwd_cell.{wx [4, In, 4H], wh [4, H, 4H], bias [16H]}`` and the
same under ``bwd_cell``; ``qlstm_<i>.cell.{wx, wh, bias}``;
``bilstm_<i>.{wx [2, In, 4H], wh [2, H, 4H], bias [2, 4H]}``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from qasr_torch.models.layers import Dense, Dropout, PReLU, QDense
from qasr_torch.models.qcnn import ConvTowerEncoder, RealConvTower
from qasr_torch.ops.initializers import glorot_uniform, lecun_normal, quaternion_init
from qasr_torch.ops.kernels.qgemm8 import qdense_pallas8
from qasr_torch.ops.kernels.qlstm_scan import qlstm_scan_fast8
from qasr_torch.ops.qlinalg import qdense
from qasr_torch.ops.quaternion import O8, V8, combine_weights, device_table, hamilton_expand
from qasr_torch.utils.profiling import traced

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


def _recur(xs: torch.Tensor, cell, hid: int, lengths: torch.Tensor | None, flipped):
    """Run ``cell(x_s, h, c) -> (h, c)`` over the steps of ``xs [T, D, B,
    ...]`` from a zero state ``[D, B, hid]``; returns ``hs [T, D, B, hid]``
    in scan order. ``lengths`` freezes each direction's state on the steps
    that are not frames of the utterance: step s of a stream that
    ``flipped[d]`` marks time-flipped is frame T-1-s. The steps' inputs are
    ``xs.unbind(0)``: indexing ``xs[s]`` in the loop would have autograd
    zero-fill a gradient of all of ``xs`` every step."""
    t, d, b = xs.shape[:3]
    h = xs.new_zeros((d, b, hid))
    c = xs.new_zeros((d, b, hid))
    out = []
    for s, xs_s in enumerate(xs.unbind(0)):
        h_new, c_new = cell(xs_s, h, c)
        if lengths is not None:
            active = torch.stack([((t - 1 - s) if f else s) < lengths
                                  for f in flipped[:d]])[:, :, None]
            h_new = torch.where(active, h_new, h)
            c_new = torch.where(active, c_new, c)
        h, c = h_new, c_new
        out.append(h)
    return torch.stack(out) if out else xs.new_zeros((0, d, b, hid))


def qlstm_fast8_scan(
    xs: torch.Tensor, wc8: torch.Tensor, lengths: torch.Tensor | None = None,
    flipped=(False, True),
) -> torch.Tensor:
    """The plain in-scan rank-8 recurrence (``qlstm.py:233-289``): ``xs [T, D,
    B, 16H]`` packed component-major (``flipped[d]``: direction d's stream is
    time-flipped; by default direction 1's), ``wc8 [D, 8, H, 4H]``; returns
    ``hs [T, D, B, 4H]`` in scan order. The combos and the gates run in the
    compute dtype, the products sum in f32, and the recombined projection is
    cast to the compute dtype before it meets ``xs``, as the JAX branch
    does. ``lengths`` freezes each direction's state on the steps that are
    not frames of the utterance."""
    _, d, b, c16 = xs.shape
    hid = c16 // 16
    dt = xs.dtype
    v8 = device_table(V8, dt, xs.device)
    o8 = device_table(O8, torch.float32, xs.device)
    wc = wc8.float()

    def cell(xs_s, h, c):
        hc = torch.einsum("dbak,pa->dbpk", h.reshape(d, b, 4, hid), v8)
        prods = torch.einsum("dbpk,dpkn->dbpn", hc.float(), wc)
        proj = torch.einsum("dbpn,qp->dbqn", prods, o8).reshape(d, b, c16).to(dt)
        return _gate_update(xs_s + proj, c)

    return _recur(xs, cell, 4 * hid, lengths, flipped)


def qlstm_block_scan(
    xs: torch.Tensor, wh_big: torch.Tensor, lengths: torch.Tensor | None = None,
    flipped=(False, True),
) -> torch.Tensor:
    """The block recurrence (``qlstm.py:243-289``, the ``else`` branches):
    ``xs [T, D, B, 16H]`` as :func:`qlstm_fast8_scan` takes it, ``wh_big [D,
    4H, 16H]`` the Hamilton-expanded recurrent weights in the compute dtype;
    returns ``hs [T, D, B, 4H]`` in scan order. Each step is one batched
    product ``[D, B, 4H] @ [D, 4H, 16H]`` in the compute dtype (summed in
    f32, rounded once), added to ``xs[s]``, then the split gates."""
    return _recur(xs, lambda xs_s, h, c: _gate_update(xs_s + torch.bmm(h, wh_big), c),
                  xs.shape[-1] // 4, lengths, flipped)


_RECURRENCES = ("pallas8", "fast8", "block")


class QLSTMLayer(nn.Module):
    """Unidirectional quaternion LSTM (``qasr/models/qlstm.py:99-171``):
    ``x [B, T, 4*In]`` -> ``[B, T, 4*H]``.

    The input projection over all ``B * T`` rows (:func:`input_proj_fn`),
    then the ``"fast8"`` or ``"block"`` recurrence with one direction;
    ``"pallas8"`` raises ``ValueError``, as the JAX layer does (kernel D
    takes both directions at once). ``reverse`` runs the recurrence from the
    last frame to the first (the stream flipped, the outputs flipped back).
    ``lengths [B]`` freezes the state on the frames past each utterance's
    length. For a reverse layer this is a deliberate divergence: the JAX
    layer, scanning with ``reverse=True`` over a reversed frame index, masks
    the first frames instead (ROADMAP.md Queue 3, "Deliberate
    divergences"); without ``lengths``, or with every length T, the two
    agree.
    """

    def __init__(
        self,
        cin: int,
        hidden: int,
        *,
        reverse: bool = False,
        dtype: torch.dtype = torch.float32,
        input_proj: str = "auto",
        recurrent: str = "fast8",
        generator: torch.Generator | None = None,
        device: torch.device | str = "cuda",
    ):
        super().__init__()
        if recurrent == "pallas8":
            raise ValueError(
                "recurrent='pallas8' is bidirectional-only (QBiLSTM); the "
                "unidirectional layer would silently fall back otherwise"
            )
        if recurrent not in _RECURRENCES:
            raise ValueError(f"unknown recurrence {recurrent!r} (choose fast8 | block)")
        self.hidden = hidden
        self.reverse = reverse
        self.dtype = dtype
        self.input_proj = input_proj
        self.recurrent = recurrent
        self.cell = QLSTMCell(cin, hidden, generator=generator, device=device)

    def forward(
        self, x: torch.Tensor, lengths: torch.Tensor | None = None, *, plain: bool = False
    ) -> torch.Tensor:
        b, t, cin4 = x.shape
        dt = self.dtype
        proj = input_proj_fn(self.input_proj, b * t)
        xz = proj(x.to(dt).reshape(b * t, cin4), self.cell.wx.to(dt), plain=plain)
        xs = (xz.reshape(b, t, -1) + self.cell.bias.to(dt)).transpose(0, 1)
        if self.reverse:
            xs = xs.flip(0)
        xs = xs.unsqueeze(1)  # [T, 1, B, 16H]
        flipped = (self.reverse,)
        if self.recurrent == "fast8":
            hs = qlstm_fast8_scan(xs, combine_weights(self.cell.wh, dt)[None], lengths, flipped)
        else:
            hs = qlstm_block_scan(xs, hamilton_expand(self.cell.wh.to(dt))[None], lengths,
                                  flipped)
        hs = hs[:, 0]
        if self.reverse:
            hs = hs.flip(0)
        return hs.transpose(0, 1)


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
        if recurrent not in _RECURRENCES:
            raise ValueError(f"unknown recurrence {recurrent!r} (choose {' | '.join(_RECURRENCES)})")
        self.hidden = hidden
        self.dtype = dtype
        self.input_proj = input_proj
        self.recurrent = recurrent
        self.fwd_cell = QLSTMCell(cin, hidden, generator=generator, device=device)
        self.bwd_cell = QLSTMCell(cin, hidden, generator=generator, device=device)

    def forward(
        self, x: torch.Tensor, lengths: torch.Tensor | None = None, *, plain: bool = False
    ) -> torch.Tensor:
        return traced("qasr.bilstm", self._forward, x, lengths, plain=plain)

    def _forward(self, x: torch.Tensor, lengths: torch.Tensor | None, *, plain: bool
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
        cells = (self.fwd_cell, self.bwd_cell)
        if self.recurrent == "block":
            wh_big = torch.stack([hamilton_expand(c.wh.to(dt)) for c in cells])  # [2, 4H, 16H]
            hs = qlstm_block_scan(xs, wh_big, lengths)
        else:
            wc8 = torch.stack([combine_weights(c.wh, dt) for c in cells])  # [2, 8, H, 4H]
            if self.recurrent == "pallas8":
                hs = qlstm_scan_fast8(xs.contiguous(), wc8, lengths, plain=plain)
            else:
                hs = qlstm_fast8_scan(xs, wc8, lengths)
        fwd = hs[:, 0].transpose(0, 1)
        bwd = hs[:, 1].flip(0).transpose(0, 1)
        return qchannel_concat([fwd, bwd])


class QLSTMEncoder(ConvTowerEncoder):
    """Quaternion conv tower + quaternion LSTM layers -> framewise CTC
    logits ``[B, T, vocab]`` in f32.

    Submodules carry the JAX names (``qconv_<i>``, ``conv_prelu_<i>``,
    ``qbilstm_<i>`` or, with ``bidirectional=False``, ``qlstm_<i>``,
    ``qdense_<i>``, ``dense_prelu_<i>``, ``output``), so a JAX
    ``QLSTMEncoder`` tree bridges by name. A bidirectional layer gives ``2 *
    lstm_features`` quaternion channels, a unidirectional one
    ``lstm_features``. Dropout follows each LSTM layer and each dense PReLU;
    in train mode its masks come from the generator the caller passes (the
    train state's), and in eval mode it is the identity.
    """

    def __init__(
        self,
        *,
        n_feats: int,
        conv_features: Sequence[int] = (64, 64, 128, 128),
        dense_features: Sequence[int] = (256,),
        lstm_features: int = 256,
        lstm_layers: int = 3,
        bidirectional: bool = True,
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
        self.bidirectional = bidirectional
        common = dict(dtype=dtype, generator=generator, device=device)
        # the JAX encoder's tower runs its default "auto" routing, or every
        # layer packed under use_pallas (qasr/models/qlstm.py:329-341)
        k = self._build_tower(n_feats, conv_features, kernel_size, pool_after, pool_size,
                              use_pallas=use_pallas, **common)
        self.lstm_layers = lstm_layers
        self._lstm_names = []
        for i in range(lstm_layers):
            if bidirectional:
                name, layer = f"qbilstm_{i}", QBiLSTM(
                    k, lstm_features, input_proj=input_proj, recurrent=recurrent, **common)
            else:
                name, layer = f"qlstm_{i}", QLSTMLayer(
                    k, lstm_features, input_proj=input_proj, recurrent=recurrent, **common)
            self.add_module(name, layer)
            self._lstm_names.append(name)
            self.add_module(f"lstm_dropout_{i}", Dropout(dropout_rate))
            k = (2 if bidirectional else 1) * lstm_features
        self.n_dense = len(dense_features)
        dense_scheme = "fast10" if use_pallas else "fast8"
        for i, feats in enumerate(dense_features):
            self.add_module(f"qdense_{i}", QDense(k, feats, scheme=dense_scheme, **common))
            self.add_module(f"dense_prelu_{i}", PReLU(4 * feats, device=device))
            self.add_module(f"dense_dropout_{i}", Dropout(dropout_rate))
            k = feats
        self.output = Dense(4 * k, vocab, **common)

    def lstm(self, i: int) -> nn.Module:
        """The ``i``-th LSTM layer (``qbilstm_<i>`` or ``qlstm_<i>``)."""
        return getattr(self, self._lstm_names[i])

    def forward(
        self,
        x: torch.Tensor,
        *,
        lengths: torch.Tensor | None = None,
        plain: bool = False,
        generator: torch.Generator | None = None,
        global_rows: tuple[int, int] | None = None,
        remat: bool = False,
    ) -> torch.Tensor:
        """``x [B, T, F, 4]`` -> logits ``[B, T, vocab]`` f32. ``lengths [B]``
        frame counts keep padding out of the recurrences. ``plain=True``
        runs every kernel's plain PyTorch version, on any device. In train
        mode the dropout masks come from ``generator``, cut to ``global_rows``
        of a larger batch when given (:class:`Dropout`). ``remat``
        recomputes the tower's conv layers in the backward, except the
        stacked ones on ``ChainLayerFn`` (``qcnn.quaternion_conv_tower``)."""
        x = self._run_tower(x, plain, remat)
        for i in range(self.lstm_layers):
            x = self.lstm(i)(x, lengths, plain=plain)
            x = getattr(self, f"lstm_dropout_{i}")(x, generator, global_rows)
        return self._run_dense(x, plain, generator, global_rows)


class RealBiLSTM(nn.Module):
    """Real bidirectional LSTM with QBiLSTM's structure
    (``qasr/models/qlstm.py:379-439``): one input product for both
    directions, one recurrence over both at once. ``hidden`` counts real
    units. ``x [B, T, In]`` -> ``[B, T, 2H]`` (forward then backward units).

    Parameters ``wx [2, In, 4H]``, ``wh [2, H, 4H]`` (flax's glorot-uniform,
    the leading 2 counted as receptive field: fan_in 2 In, fan_out 2 x 4H)
    and ``bias [2, 4H]`` (zeros). The input product sums in f32 and rounds
    once to the compute dtype (a bf16 GEMM accumulates in f32), as the JAX
    ``preferred_element_type=f32`` dot then its cast; each step's recurrent
    product ``[2, B, H] @ [2, H, 4H]`` runs in the compute dtype; the gates
    are real, i, f, o, g in that order along 4H. A plain loop of batched
    products, not ``nn.LSTM``: cuDNN's gate order, its second bias and its
    carry are not the reference's.
    """

    def __init__(
        self,
        cin: int,
        hidden: int,
        *,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
        device: torch.device | str = "cuda",
    ):
        super().__init__()
        self.hidden = hidden
        self.dtype = dtype
        init = dict(generator=generator, device=device)
        self.wx = nn.Parameter(glorot_uniform((2, cin, 4 * hidden), **init))
        self.wh = nn.Parameter(glorot_uniform((2, hidden, 4 * hidden), **init))
        self.bias = nn.Parameter(torch.zeros(2, 4 * hidden, device=device))

    def forward(
        self, x: torch.Tensor, lengths: torch.Tensor | None = None, *, plain: bool = False
    ) -> torch.Tensor:
        del plain  # no kernel to swap
        b, t, cin = x.shape
        dt, h4 = self.dtype, 4 * self.hidden
        wx = self.wx.to(dt).transpose(0, 1).reshape(cin, 2 * h4)
        z = (x.to(dt).reshape(b * t, cin) @ wx).reshape(b, t, 2, h4) + self.bias.to(dt)
        # [T, 2, B, 4H], the backward stream time-flipped
        xs = torch.stack([z[:, :, 0].transpose(0, 1), z[:, :, 1].transpose(0, 1).flip(0)], dim=1)
        wh = self.wh.to(dt)

        def cell(xs_s, h, c):
            zi, zf, zo, zg = (xs_s + torch.bmm(h, wh)).chunk(4, dim=-1)
            c_new = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zg)
            return torch.sigmoid(zo) * torch.tanh(c_new), c_new

        hs = _recur(xs, cell, self.hidden, lengths, (False, True))
        return torch.cat([hs[:, 0].transpose(0, 1), hs[:, 1].flip(0).transpose(0, 1)], dim=-1)


class RealLSTMEncoder(RealConvTower):
    """Real CNN-LSTM at equal real width, config 4's ablation
    (``qasr/models/qlstm.py:442-499``): ``RealCNNEncoder``'s convs (``4 *
    conv_features`` channels, PReLUs, the frequency pool), ``lstm_layers``
    :class:`RealBiLSTM` layers of ``4 * lstm_features`` real units, real
    dense layers of ``4 * dense_features`` with PReLUs, the output layer ->
    framewise CTC logits ``[B, T, vocab]`` in f32. Dropout follows each
    LSTM layer and each dense PReLU (masks from the caller's generator in
    train mode). Every conv and dense kernel, the output head's too, is
    flax's default lecun-normal. Names: ``conv_<i>``, ``conv_prelu_<i>``,
    ``bilstm_<i>``, ``dense_<i>``, ``dense_prelu_<i>``, ``output``.
    ``bidirectional=False`` raises ``NotImplementedError``, as the JAX
    encoder does.
    """

    def __init__(
        self,
        *,
        n_feats: int,
        conv_features: Sequence[int] = (64, 64, 128, 128),
        dense_features: Sequence[int] = (256,),
        lstm_features: int = 256,
        lstm_layers: int = 3,
        bidirectional: bool = True,
        vocab: int = 32,
        kernel_size: tuple[int, int] = (3, 3),
        pool_after: int = 1,
        pool_size: int = 3,
        dropout_rate: float = 0.3,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
        device: torch.device | str = "cuda",
    ):
        super().__init__()
        if not bidirectional and lstm_layers:
            raise NotImplementedError("real ablation is bidirectional-only")
        self.dtype = dtype
        common = dict(dtype=dtype, generator=generator, device=device)
        k = self._build_convs(n_feats, conv_features, kernel_size, pool_after, pool_size,
                              **common)
        self.lstm_layers = lstm_layers
        for i in range(lstm_layers):
            self.add_module(f"bilstm_{i}", RealBiLSTM(k, 4 * lstm_features, **common))
            self.add_module(f"lstm_dropout_{i}", Dropout(dropout_rate))
            k = 2 * 4 * lstm_features
        self.n_dense = len(dense_features)
        for i, feats in enumerate(dense_features):
            self.add_module(f"dense_{i}", Dense(k, 4 * feats, kernel_init=lecun_normal, **common))
            self.add_module(f"dense_prelu_{i}", PReLU(4 * feats, device=device))
            self.add_module(f"dense_dropout_{i}", Dropout(dropout_rate))
            k = 4 * feats
        self.output = Dense(k, vocab, kernel_init=lecun_normal, **common)

    def forward(
        self,
        x: torch.Tensor,
        *,
        lengths: torch.Tensor | None = None,
        plain: bool = False,
        generator: torch.Generator | None = None,
        global_rows: tuple[int, int] | None = None,
        remat: bool = False,
    ) -> torch.Tensor:
        """``x [B, T, F, 4]`` -> logits ``[B, T, vocab]`` f32. ``lengths [B]``
        reaches every LSTM layer; ``plain`` is accepted and unused (the model
        runs no kernel of the port). In train mode the dropout masks come
        from ``generator``, cut to ``global_rows`` of a larger batch when
        given (:class:`Dropout`); ``remat`` recomputes each conv layer in
        the backward (``qcnn.segment``)."""
        x = self._run_convs(x, remat)
        for i in range(self.lstm_layers):
            x = getattr(self, f"bilstm_{i}")(x, lengths)
            x = getattr(self, f"lstm_dropout_{i}")(x, generator, global_rows)
        for i in range(self.n_dense):
            x = getattr(self, f"dense_prelu_{i}")(getattr(self, f"dense_{i}")(x))
            x = getattr(self, f"dense_dropout_{i}")(x, generator, global_rows)
        return self.output(x).float()
