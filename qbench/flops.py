"""Operation and byte counts of the models' layers, the yardstick of every
share of peak and roofline the benchmark reports.

The 8-product rule: a quaternion product ``w ⊗ x`` of a ``Cin x Cout`` block
costs 8 real products of ``Cin x Cout`` blocks, whatever implements it. The
bilinear rank of quaternion multiplication over the reals is 8, so no
bilinear algorithm needs fewer; the 4x-expanded real matrix spends 16 (a
block path, cuDNN on the expanded kernel), the 10-product scheme 10 and the
rank-8 kernels 8. Counting 8 for all of them makes a share of peak read the
same work whatever kernel runs, so no implementation can read above 100%.
A real product of an ``M x K`` by a ``K x N`` matrix counts ``2 M K N``.

Counts cover the products only (convolutions, GEMMs, the recurrent
products); elementwise work (PReLU, pooling, gates, softmax, CTC) is not
counted. Frames are the real (unpadded) frames of each row, so work spent on
padding raises no share. Bytes count each input of a layer read once and
each output written once, in the compute dtype, with f32 master weights
read once where a layer casts them.
"""

from __future__ import annotations

from dataclasses import dataclass

#: real products per quaternion product (the bilinear rank, see above)
QUATERNION_PRODUCTS = 8


def qproduct_flops(cin: int, cout: int, taps: int = 1) -> int:
    """FLOPs of one quaternion product per output position: ``Cin x Cout``
    quaternion weights over ``taps`` kernel taps, 8 real products of 2 FLOPs
    a multiply-add."""
    return 2 * QUATERNION_PRODUCTS * cin * cout * taps


def real_dense_flops(k: int, n: int) -> int:
    """FLOPs of a real ``K -> N`` dense layer per row: ``2 K N``."""
    return 2 * k * n


def qconv_flops(b: int, t: int, f: int, cin: int, cout: int, kh: int = 3, kw: int = 3) -> int:
    """Forward FLOPs of one SAME quaternion conv of ``Cin -> Cout`` quaternion
    channels at ``b x t x f`` output positions (time stride 1)."""
    return b * t * f * qproduct_flops(cin, cout, kh * kw)


def qconv_bytes(frames: int, f: int, cin: int, cout: int, kh: int = 3, kw: int = 3,
                itemsize: int = 2) -> int:
    """Forward bytes of a quaternion conv over ``frames`` (rows x time)
    positions of ``f`` bins: the input and the output activations once, the
    quaternion kernel once (f32 master)."""
    act = frames * f * 4 * (cin + cout) * itemsize
    return act + 4 * kh * kw * cin * cout * 4


def qconv_backward_bytes(frames: int, f: int, cin: int, cout: int, kh: int = 3, kw: int = 3,
                         itemsize: int = 2) -> int:
    """Backward bytes of a quaternion conv: dx reads dz and the input (for
    the fused PReLU) and writes dx; dW reads the input and dz again and
    writes the f32 kernel gradient; the kernel is read once."""
    dz = frames * f * 4 * cout * itemsize
    x = frames * f * 4 * cin * itemsize
    w = 4 * kh * kw * cin * cout * 4
    return (dz + x + x) + (x + dz) + 2 * w


@dataclass(frozen=True)
class ConvLayer:
    """One conv of the tower: quaternion channels in and out, the frequency
    bins it works on, and whether it runs in the stacked layout (after the
    pool, where the port's stacked kernels take it)."""

    cin: int
    cout: int
    f: int
    kh: int
    kw: int
    stacked: bool


def tower_layers(n_mels: int, conv_features, kernel_size=(3, 3), pool_after: int = 1,
                 pool_size: int = 3) -> list[ConvLayer]:
    """The conv tower's layers: the thin layer(s) at ``n_mels`` bins, the
    frequency pool after ``pool_after`` layers, then the layers at the
    pooled width, which the port runs stacked."""
    kh, kw = kernel_size
    out, cin, f = [], 1, n_mels
    for i, feats in enumerate(conv_features):
        out.append(ConvLayer(cin, feats, f, kh, kw, stacked=i >= pool_after))
        if i + 1 == pool_after:
            f = (f - pool_size) // pool_size + 1
        cin = feats
    return out


def tower_width(n_mels: int, conv_features, pool_after: int = 1, pool_size: int = 3) -> int:
    """Quaternion channels the tower hands on per frame: ``F' * C``."""
    f = n_mels
    for i in range(len(conv_features)):
        if i + 1 == pool_after:
            f = (f - pool_size) // pool_size + 1
    return f * conv_features[-1]


@dataclass(frozen=True)
class ModelShape:
    """What the counts read of a configuration (the keys of the port's
    ``ModelConfig`` and ``DataConfig``)."""

    arch: str
    n_mels: int
    conv_features: tuple
    dense_features: tuple
    vocab: int
    kernel_size: tuple = (3, 3)
    pool_after: int = 1
    pool_size: int = 3
    lstm_features: int = 0
    lstm_layers: int = 0
    bidirectional: bool = True
    itemsize: int = 2

    @staticmethod
    def from_config(model: dict, data: dict) -> "ModelShape":
        dtype = model.get("compute_dtype", "float32")
        itemsize = {"bfloat16": 2, "float16": 2, "float32": 4}[dtype]
        return ModelShape(
            arch=model["arch"], n_mels=data["n_mels"],
            conv_features=tuple(model["conv_features"]),
            dense_features=tuple(model["dense_features"]), vocab=model["vocab"],
            kernel_size=tuple(model.get("kernel_size", (3, 3))),
            pool_after=model.get("pool_after", 1), pool_size=model.get("pool_size", 3),
            lstm_features=model.get("lstm_features", 0),
            lstm_layers=model.get("lstm_layers", 0),
            bidirectional=model.get("bidirectional", True), itemsize=itemsize,
        )

    def layers(self) -> list[ConvLayer]:
        return tower_layers(self.n_mels, self.conv_features, self.kernel_size,
                            self.pool_after, self.pool_size)


def conv_frame_flops(m: ModelShape, stacked_only: bool = False) -> int:
    """Forward FLOPs of the conv tower per frame (all layers, or the stacked
    ones)."""
    return sum(l.f * qproduct_flops(l.cin, l.cout, l.kh * l.kw) for l in m.layers()
               if l.stacked or not stacked_only)


def lstm_dims(m: ModelShape) -> list[int]:
    """Input quaternion channels of each LSTM layer."""
    k = tower_width(m.n_mels, m.conv_features, m.pool_after, m.pool_size)
    dirs = 2 if m.bidirectional else 1
    out = []
    for _ in range(m.lstm_layers):
        out.append(k)
        k = dirs * m.lstm_features
    return out


def recurrence_frame_flops(m: ModelShape) -> int:
    """Forward FLOPs of the LSTM layers' recurrent products per frame: each
    direction of each layer multiplies ``h [H]`` by ``W_h [H, 4H]`` a
    frame."""
    dirs = 2 if m.bidirectional else 1
    return m.lstm_layers * dirs * qproduct_flops(m.lstm_features, 4 * m.lstm_features)


def frame_flops(m: ModelShape) -> int:
    """Forward model FLOPs per frame of the whole encoder: the conv tower,
    the LSTM layers' input and recurrent products, the quaternion dense
    layers and the real output layer."""
    total = conv_frame_flops(m)
    dirs = 2 if m.bidirectional else 1
    for cin in lstm_dims(m):
        total += dirs * qproduct_flops(cin, 4 * m.lstm_features)
    total += recurrence_frame_flops(m)
    if m.lstm_layers:
        k = dirs * m.lstm_features
    else:
        k = tower_width(m.n_mels, m.conv_features, m.pool_after, m.pool_size)
    for n in m.dense_features:
        total += qproduct_flops(k, n)
        k = n
    return total + real_dense_flops(4 * k, m.vocab)


def model_flops(m: ModelShape, real_frames: int, train: bool) -> int:
    """Model FLOPs of ``real_frames`` frames: the forward, and for training
    twice that again for the backward (recomputation not counted)."""
    return frame_flops(m) * real_frames * (3 if train else 1)


def least_seconds(flops: float, nbytes: float, peak_flops: float, peak_bytes: float) -> float:
    """The least time the chip could take: the larger of the FLOPs over the
    peak rate and the bytes over the memory bandwidth."""
    return max(flops / peak_flops, nbytes / peak_bytes)


def stacked_conv_least_seconds(m: ModelShape, rows_frames: int, train: bool,
                               peak_flops: float, peak_bytes: float) -> float:
    """Least time of the stacked convs over ``rows_frames`` real frames: per
    layer its forward, and in training its dx and its dW (each the forward's
    FLOPs), each pass bounded by its own FLOPs or bytes."""
    total = 0.0
    for l in m.layers():
        if not l.stacked:
            continue
        fl = rows_frames * l.f * qproduct_flops(l.cin, l.cout, l.kh * l.kw)
        total += least_seconds(fl, qconv_bytes(rows_frames, l.f, l.cin, l.cout, l.kh, l.kw,
                                               m.itemsize), peak_flops, peak_bytes)
        if train:
            bwd_bytes = qconv_backward_bytes(rows_frames, l.f, l.cin, l.cout, l.kh, l.kw,
                                             m.itemsize)
            total += least_seconds(2 * fl, bwd_bytes, peak_flops, peak_bytes)
    return total


def recurrence_bytes(m: ModelShape, rows_frames: int, train: bool) -> tuple[int, int]:
    """(forward, backward) bytes of the LSTM layers' recurrences over
    ``rows_frames`` real frames. Forward: the input projections ``xz [16H]``
    read and ``h [4H]`` written a frame and direction, the f32 recurrent
    kernel read once a layer and direction. Backward: ``dh``, the gates,
    ``c`` and ``h`` read, ``dz`` written a frame and direction, the kernel
    read and its f32 gradient written once."""
    h = m.lstm_features
    dirs = 2 if m.bidirectional else 1
    w = 4 * h * 4 * h * 4
    per = m.lstm_layers * dirs
    fwd = per * (rows_frames * (16 * h + 4 * h) * m.itemsize + w)
    bwd = per * (rows_frames * (4 * h + 16 * h + 4 * h + 4 * h + 16 * h) * m.itemsize + 2 * w)
    return fwd, (bwd if train else 0)


def recurrence_least_seconds(m: ModelShape, rows_frames: int, train: bool,
                             peak_flops: float, peak_bytes: float) -> float:
    """Least time of the recurrences over ``rows_frames`` real frames: the
    forward's recurrent products, and in training the backward's recurrent
    products (the gradient of ``h``) and the weight gradient, each pass
    bounded by its FLOPs or its bytes."""
    fl = rows_frames * recurrence_frame_flops(m)
    fwd_b, bwd_b = recurrence_bytes(m, rows_frames, train)
    total = least_seconds(fl, fwd_b, peak_flops, peak_bytes)
    if train:
        total += least_seconds(2 * fl, bwd_b, peak_flops, peak_bytes)
    return total
