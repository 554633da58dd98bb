"""Core quaternion algebra for Hamilton-product layers (PyTorch).

Counterpart of ``qasr/ops/quaternion.py``; the tables are the same numbers.
Packed layout: a tensor with C quaternion channels is a real tensor whose
trailing dim is ``4*C`` in component-major order ``[r.., i.., j.., k..]``.
Weights are one stacked tensor ``W[4, ..., Cin, Cout]``.

Hamilton product convention (y = w ⊗ x, weight acting on the left):

    y_r = Wr·xr − Wi·xi − Wj·xj − Wk·xk
    y_i = Wr·xi + Wi·xr + Wj·xk − Wk·xj
    y_j = Wr·xj + Wj·xr + Wk·xi − Wi·xk
    y_k = Wr·xk + Wk·xr + Wi·xj − Wj·xi
"""

from __future__ import annotations

import numpy as np
import torch

R, I, J, K = 0, 1, 2, 3

# y_b = sum_a sign[a][b] * x_a @ W[comp[a][b]]; rows = input component a,
# cols = output component b
HAMILTON_COMP = np.array(
    [
        [R, I, J, K],
        [I, R, K, J],
        [J, K, R, I],
        [K, J, I, R],
    ],
    dtype=np.int32,
)
HAMILTON_SIGN = np.array(
    [
        [1, 1, 1, 1],
        [-1, 1, 1, -1],
        [-1, -1, 1, 1],
        [-1, 1, -1, 1],
    ],
    dtype=np.int32,
)

# E[c, a, b] = sign[a, b] * 1{comp[a, b] == c}: the (a, b) block of the 4x4
# expanded matrix is sum_c E[c, a, b] * w[c]
HAMILTON_E = np.zeros((4, 4, 4), np.float32)
for _a in range(4):
    for _b in range(4):
        HAMILTON_E[int(HAMILTON_COMP[_a, _b]), _a, _b] = float(HAMILTON_SIGN[_a, _b])

# 10-multiplication scheme: rows = the 10 products, cols = (r, i, j, k)
X_COMBO = np.array(
    [
        [1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1],
        [1, 1, 0, 0], [0, 0, 1, 1], [1, 0, 1, 0], [0, 1, 0, 1],
        [1, 0, 0, 1], [0, 1, 1, 0],
    ],
    dtype=np.float32,
)
W_COMBO = np.array(
    [
        [1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1],
        [1, 1, 0, 0], [0, 0, 1, -1], [1, 0, 1, 0], [0, -1, 0, 1],
        [1, 0, 0, 1], [0, 1, -1, 0],
    ],
    dtype=np.float32,
)
# rows = output components (r, i, j, k); cols = the 10 products
OUT_COMBO = np.array(
    [
        [1, -1, -1, -1, 0, 0, 0, 0, 0, 0],
        [-1, -1, -1, 1, 1, 1, 0, 0, 0, 0],
        [-1, 1, -1, -1, 0, 0, 1, 1, 0, 0],
        [-1, -1, 1, -1, 0, 0, 0, 0, 1, 1],
    ],
    dtype=np.float32,
)

# Exact rank-8 scheme (the bilinear rank of quaternion multiplication):
#   prod_p = (Σ_a U8[p,a] w_a) · (Σ_a V8[p,a] x_a),   y_b = Σ_p O8[b,p] prod_p
# V8 rows have two nonzeros; U8 lives on the weight side; O8 is dense.
U8 = np.array([
    [-0.41134848995960666, -1.89911105715955, -1.6081577100916444, -0.2830177865031355],
    [-2.0002010968731994, 1.1923724898812937, -0.14584853038532697, -0.039972063029792726],
    [-1.7575503310010283, 0.3525711467091218, 0.23758858505076308, -1.3885017354386253],
    [-1.2647601436934603, -1.9928792483501931, -0.20893727813149843, -0.026890051237025675],
    [-1.422885414406715, -0.41364218483401466, -0.41268414926265184, 1.356973490598023],
    [-0.41348667546468526, 0.3752519092863721, -1.118442139724733, -1.7062214536864513],
    [0.43514041891738603, -1.4008969396946274, 1.4349888685965422, 0.4304451237930994],
    [0.24777709857135102, 0.5543302028802017, 1.788705629898477, -1.0215471431842396],
], dtype=np.float64)
V8 = np.array([
    [0.0, 0.4513786445826455, 0.0, 0.8923325160569082],
    [0.8446318483303761, -0.5353475887534835, 0.0, 0.0],
    [0.8475335129218723, 0.0, -0.5307418812119522, 0.0],
    [0.0, 0.0, 0.5351701533441554, 0.8447442849568957],
    [-0.7028365579661247, 0.0, -0.7113513708318894, 0.0],
    [-0.6828031123792481, -0.7306024293164547, 0.0, 0.0],
    [0.0, 0.781536511377488, 0.0, -0.6238595045214324],
    [0.0, 0.0, 0.682885397420987, -0.7305255190526655],
], dtype=np.float64)
O8 = np.array([
    [0.6261460263168904, -0.01767477854650512, -0.3870646792669045, -0.16414261279326867, 0.4094475742742699, -0.056301890266540845, 0.44752562851604755, -0.9720666782625007],
    [-0.33545488689537056, 0.9643638498922589, -0.5930157361554107, 0.23021875668841382, 0.736780997967462, 0.0320916070897509, -0.3076453760319158, -0.21721813550164476],
    [0.34554159148622104, -0.06153785859793262, 0.573149817907253, 0.011662710438349832, 0.4766460235894757, 0.9673691779622062, -0.4769016103208764, -0.05431815127358439],
    [0.6131983212115742, 0.256715911429653, -0.41232578983948065, -0.959124865654911, -0.24962975213152433, 0.24494305345008152, -0.6911150327540616, -0.0703718200778613],
], dtype=np.float64)


# the transposes that call sites take of the tables, kept so that each is one
# array (device_table's cache holds it)
O8_T = np.ascontiguousarray(O8.T)
HAMILTON_COMP_FLAT = HAMILTON_COMP.reshape(-1)

# (id of the numpy table, dtype, device) -> (table, tensor)
_DEVICE_TABLES: dict[tuple[int, torch.dtype, torch.device], tuple[np.ndarray, torch.Tensor]] = {}


def device_table(table: np.ndarray, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``table`` as a ``dtype`` tensor on ``device``, made once per (table,
    dtype, device) and kept: after the first call no host-to-device copy
    (which would synchronise the stream) happens again. ``table`` is a
    module-level array that lives as long as the process (the cache holds
    it, so its id is never reused); the tensor returned is shared, so
    callers must not write to it."""
    device = torch.device(device)
    key = (id(table), dtype, device)
    hit = _DEVICE_TABLES.get(key)
    if hit is None:
        hit = (table, torch.as_tensor(table, dtype=dtype, device=device))
        _DEVICE_TABLES[key] = hit
    return hit[1]


def split_components(x: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Split packed ``[..., 4C]`` into four ``[..., C]`` components (r,i,j,k)."""
    c4 = x.shape[-1]
    if c4 % 4:
        raise ValueError(f"packed quaternion dim must be divisible by 4, got {c4}")
    return tuple(torch.chunk(x, 4, dim=-1))


def pack_components(r, i, j, k) -> torch.Tensor:
    """Concatenate four ``[..., C]`` components into packed ``[..., 4C]``."""
    return torch.cat([r, i, j, k], dim=-1)


def hamilton_expand(w: torch.Tensor, conjugate: bool = False) -> torch.Tensor:
    """Expand stacked weights ``[4, *spatial, Cin, Cout]`` into the 4x4 block
    real matrix ``[*spatial, 4*Cin, 4*Cout]`` (exact: a signed selection)."""
    if conjugate:
        w = torch.cat([w[:1], -w[1:]], dim=0)
    n_sp = w.ndim - 3
    comp = device_table(HAMILTON_COMP_FLAT, torch.long, w.device)
    wb = w.index_select(0, comp).reshape(4, 4, *w.shape[1:])
    sign = device_table(HAMILTON_SIGN, w.dtype, w.device)
    wb = wb * sign.reshape(4, 4, *([1] * (w.ndim - 1)))
    # [a, b, *sp, K, N] -> [*sp, a, K, b, N] -> [*sp, 4K, 4N]
    perm = tuple(range(2, 2 + n_sp)) + (0, 2 + n_sp, 1, 3 + n_sp)
    wb = wb.permute(perm)
    return wb.reshape(*w.shape[1:-2], 4 * w.shape[-2], 4 * w.shape[-1])


def hamilton_tensor() -> np.ndarray:
    """The 4x4x4 product tensor T with ``y_k = Σ_ij T[i,j,k] w_i x_j``, the
    object the 10- and 8-product schemes decompose
    (``qasr/ops/quaternion.py:hamilton_tensor``; a test oracle)."""
    return HAMILTON_E.astype(np.float64)


def qdense_naive(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Oracle: quaternion dense as 16 explicit component GEMMs
    (``qasr/ops/quaternion.py:qdense_naive``). ``x [..., 4*Cin]`` packed,
    ``w [4, Cin, Cout]``; used only by tests."""
    xs = split_components(x)
    outs = []
    for b in range(4):
        acc = None
        for a in range(4):
            term = float(HAMILTON_SIGN[a, b]) * (xs[a] @ w[int(HAMILTON_COMP[a, b])])
            acc = term if acc is None else acc + term
        outs.append(acc)
    return torch.cat(outs, dim=-1)


def hamilton_product(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Elementwise Hamilton product of packed quaternion tensors (q1 ⊗ q2)."""
    ar, ai, aj, ak = split_components(q1)
    br, bi, bj, bk = split_components(q2)
    return pack_components(
        ar * br - ai * bi - aj * bj - ak * bk,
        ar * bi + ai * br + aj * bk - ak * bj,
        ar * bj + aj * br + ak * bi - ai * bk,
        ar * bk + ak * br + ai * bj - aj * bi,
    )


def combine_weights(
    w: torch.Tensor, dtype: torch.dtype | None = None, table: np.ndarray = U8
) -> torch.Tensor:
    """Weight-side combos ``wc[p] = Σ_a table[p, a] w[a]``: ``[4, ...] ->
    [P, ...]``, formed as the reference's ``einsum(w, asarray(table,
    w.dtype))``: the table rounded to w's dtype, the products and their sum
    in f32 (a bf16 product is exact there), one rounding to w's dtype, then
    a cast to ``dtype`` (default w's). So bf16 weights get bf16-rounded U8
    coefficients, and f32 weights (the recurrent combos) an f32 sum rounded
    once to ``dtype``."""
    t = device_table(table, w.dtype, w.device).float()
    wc = torch.tensordot(t, w.float(), dims=([1], [0]))
    return wc.to(w.dtype).to(dtype or w.dtype)
