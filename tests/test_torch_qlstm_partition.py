"""The partitions kernels D and E use on the card, emulated on the CPU.

Kernel E (``csrc/qlstm_scan8_bwd.cu``) partitions the backward's recurrent
product by the columns of dprods a block's own cells give (a
reduce-scatter): block k of a direction holds ``wc8[d, p, :, N_k]`` (N_k =
``{g H + j : j in its kJ indices}``), multiplies its own columns of dprods
and folds V8 into an f32 partial of ``dh_rec [B, 4H]`` in p order; the
partials meet in block order. Kernel D (``csrc/qlstm_scan8.cu``) forms the
V8 combos once, where h is written, and in bf16 splits each product's K
over two warps by the parity of its 16-deep k-steps, the halves added in
that order. Both keep every rounding point of the plain versions; only f32
sums run in another order.

The emulations below run those partitions in torch and are held against
the plain versions (``qlstm_scan_bwd_plain``, ``qlstm_scan_fwd_plain``) and
against the JAX package's ``_bwd_xla`` and ``_fwd_xla`` (one ``jax.jit``
each, as tests/test_torch_qlstm*.py run them), at H = 32 and 48 (E's blocks
of kJ = 8 in bf16, 4 in f32; D's k-steps an odd count at 48), B = 3 and 40,
ragged lengths. Tolerances: f32 1e-5 (sums in another order). bf16: hs, cs
and gates at least 95% equal and rel-norm at most 1e-3, as
tests/test_torch_qlstm.py holds the plain forward against ``_fwd_xla`` (a
carry rounded every step moves a value to the neighbouring bf16 number now
and then); dz at least 97% equal and rel-norm at most 1e-3: another f32 sum
order moves a dprods value across a bf16 rounding boundary now and then,
and the f32 carry spreads that to later steps (measured: 97.9-99.99% equal,
rel-norm 5e-6 to 5.2e-4). The control that never rounds dprods (the backward
in f32, dz rounded at the end) is 84-90% equal at rel-norm 1.3e-3 to 1.5e-3;
the test checks that it fails, so the limits pin the rounding points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr.ops.pallas import qlstm_scan as jscan
from qasr_torch.ops.kernels import qlstm_scan
from qasr_torch.ops.quaternion import O8

torch.set_num_threads(1)
TOL_F32 = dict(rtol=1e-5, atol=1e-5)
_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
_KJ_BWD = {torch.bfloat16: 8, torch.float32: 4}  # kernel E's hidden indices a block
_KSTEP = 16  # kernel D's k-step (mma m16n8k16)


def _bwd_partition(wc8, gates, cs, dhs, lengths):
    """dz as kernel E forms it: the elementwise part and dprods as the plain
    version, then, per block k, its columns' products folded with V8 (p
    ascending, the first term assigned) into an f32 partial, the partials
    summed in block order."""
    t, d, b, c16 = gates.shape
    hid = c16 // 16
    h4, dt = 4 * hid, gates.dtype
    kj = _KJ_BWD[dt]
    w = wc8.to(dt).float()  # [D, 8, H, 4H]
    o8 = torch.tensor(O8, dtype=torch.float32)
    mask = qlstm_scan.activity_mask(t, d, lengths, b, "cpu")[..., None]
    cols = [torch.tensor([g * hid + k * kj + jj for g in range(4) for jj in range(kj)])
            for k in range(hid // kj)]
    dh = torch.zeros((d, b, h4))
    dc = torch.zeros_like(dh)
    dzs = [None] * t
    for s in range(t - 1, -1, -1):
        i_t, f_t, o_t, g_t = gates[s].float().split(h4, dim=-1)
        cpf = cs[s - 1].float() if s > 0 else torch.zeros_like(dh)
        th = torch.tanh(f_t * cpf + i_t * g_t)
        m = mask[s]
        dh_tot = dhs[s].float() + dh
        dh_cand = m * dh_tot
        dc_cand = m * dc + dh_cand * o_t * (1.0 - th * th)
        dz = torch.cat([dc_cand * g_t * i_t * (1.0 - i_t), dc_cand * cpf * f_t * (1.0 - f_t),
                        dh_cand * th * o_t * (1.0 - o_t), dc_cand * i_t * (1.0 - g_t * g_t)],
                       dim=-1)
        dc = (1.0 - m) * dc + dc_cand * f_t
        dzs[s] = dz.to(dt)
        zq = dz.reshape(d, b, 4, 4, hid)  # [D, B, g, q, H]
        dprods = []
        for p in range(8):
            acc = zq[:, :, :, 0] * o8[0, p]
            for q in range(1, 4):
                acc = acc + zq[:, :, :, q] * o8[q, p]
            dprods.append(acc.reshape(d, b, h4))
        dprods = torch.stack(dprods, dim=1).to(dt).float()  # [D, 8, B, 4H]
        parts = []
        for n_k in cols:  # block k
            dhc = torch.matmul(dprods[..., n_k], w[..., n_k].transpose(-1, -2))  # [D, 8, B, H]
            part = []
            for terms in qlstm_scan._V8_COLS:
                (p0, c0), *rest = terms
                acc = dhc[:, p0] * c0
                for p, coef in rest:
                    acc = acc + dhc[:, p] * coef
                part.append(acc)
            parts.append(torch.cat(part, dim=-1))
        dh_rec = parts[0]
        for part in parts[1:]:  # the blocks' partials, in block order
            dh_rec = dh_rec + part
        dh = (1.0 - m) * dh_tot + dh_rec
    return torch.stack(dzs)


def _fwd_partition(xz_gm, wc8, lengths):
    """hs, cs and gates as kernel D forms them: the combos of h once (f32,
    rounded to the storage dtype), in bf16 each product as two halves over
    the 16-deep k-steps of even and odd index, added in that order; the fold
    and the cell update as the plain version."""
    t, d, b, c16 = xz_gm.shape
    hid = c16 // 16
    h4, dt = 4 * hid, xz_gm.dtype
    wc = wc8.to(dt).float()
    o8 = torch.tensor(O8, dtype=torch.float32)
    mask = qlstm_scan.activity_mask(t, d, lengths, b, "cpu")[..., None]
    steps = [torch.arange(k0, k0 + _KSTEP) for k0 in range(0, hid, _KSTEP)]
    halves = [torch.cat(steps[s::2]) for s in range(2) if steps[s::2]]
    h = xz_gm.new_zeros((d, b, h4))
    c = xz_gm.new_zeros((d, b, h4))
    hs, cs, gs = [], [], []
    for s in range(t):
        hf = h.float()
        ha = hf.reshape(d, b, 4, hid)
        hc = torch.stack([ha[:, :, a1] * c1 + ha[:, :, a2] * c2
                          for (a1, c1), (a2, c2) in qlstm_scan._V8_TERMS], dim=1).to(dt).float()
        if dt == torch.bfloat16:
            prods = None
            for ks in halves:
                half = torch.matmul(hc[..., ks], wc[:, :, ks])
                prods = half if prods is None else prods + half
        else:
            prods = torch.matmul(hc, wc)
        proj = torch.einsum("dpbgh,qp->dbgqh", prods.reshape(d, 8, b, 4, hid), o8)
        z = xz_gm[s].float() + proj.reshape(d, b, c16)
        sig = torch.sigmoid(z[..., : 3 * h4])
        g_t = torch.tanh(z[..., 3 * h4:])
        i_t, f_t, o_t = sig.split(h4, dim=-1)
        cf = c.float()
        c_cand = f_t * cf + i_t * g_t
        h_cand = o_t * torch.tanh(c_cand)
        m = mask[s]
        h = (m * h_cand + (1.0 - m) * hf).to(dt)
        c = (m * c_cand + (1.0 - m) * cf).to(dt)
        hs.append(h)
        cs.append(c)
        gs.append(torch.cat([sig, g_t], dim=-1).to(dt))
    return torch.stack(hs), torch.stack(cs), torch.stack(gs)


def _inputs(t, b, hid, seed):
    """xz (gate-major), wc8, signed dhs, ragged lengths, from numpy."""
    rng = np.random.default_rng(seed)
    xz = (rng.standard_normal((t, 2, b, 16 * hid)) * 0.5).astype(np.float32)
    wc8 = (rng.standard_normal((2, 8, hid, 4 * hid)) / np.sqrt(hid)).astype(np.float32)
    dhs = rng.standard_normal((t, 2, b, 4 * hid)).astype(np.float32)
    lengths = rng.integers(1, t + 1, size=b).astype(np.int32)
    lengths[0] = t
    return (qlstm_scan.to_gate_major(torch.from_numpy(xz)), torch.from_numpy(wc8),
            torch.from_numpy(dhs), torch.from_numpy(lengths))


def _jax_mask(t, b, lengths, jdt):
    mask = qlstm_scan.activity_mask(t, 2, lengths, b, "cpu").numpy()
    return jnp.broadcast_to(jnp.asarray(mask)[..., None], (t, 2, b, 128)).astype(jdt)


def _j(x, dtype):
    return jnp.asarray(x.float().numpy()).astype(_JDT[dtype])


def _close(got, want, dtype, equal, rel, what):
    got, want = got.float().numpy(), np.asarray(want, dtype=np.float32)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, err_msg=what, **TOL_F32)
        return
    assert (got == want).mean() >= equal, what
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= rel, what


CASES = [(32, 3, 14), (48, 40, 9)]  # (H, B, T)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hid,b,t", CASES)
def test_bwd_partition_matches_plain_and_bwd_xla(dtype, hid, b, t):
    """Kernel E's reduce-scatter: dz against the plain backward and against
    ``_bwd_xla``, on the residuals of a plain forward."""
    xz, wc8, dhs, lengths = _inputs(t, b, hid, seed=hid + b)
    xz, wc8, dhs = xz.to(dtype), wc8.to(dtype), dhs.to(dtype)
    _, cs, gates = qlstm_scan.qlstm_scan_fwd_plain(xz, wc8, lengths)
    got = _bwd_partition(wc8, gates, cs, dhs, lengths)
    assert got.dtype == dtype and got.shape == gates.shape
    plain = qlstm_scan.qlstm_scan_bwd_plain(wc8, gates, cs, dhs, lengths)
    _close(got, plain.float().numpy(), dtype, 0.97, 1e-3, "against the plain version")
    jcs = _j(cs, dtype)
    jcp = jnp.concatenate([jnp.zeros_like(jcs[:1]), jcs[:-1]])
    bwd = jax.jit(jscan._bwd_xla)
    want = bwd(jnp.swapaxes(_j(wc8, dtype), 2, 3), _j(gates, dtype), jcp, _j(dhs, dtype),
               _jax_mask(t, b, lengths, _JDT[dtype]))
    _close(got, want.astype(jnp.float32), dtype, 0.97, 1e-3, "against _bwd_xla")
    if dtype == torch.bfloat16:
        ctl = qlstm_scan.qlstm_scan_bwd_plain(wc8.float(), gates.float(), cs.float(),
                                              dhs.float(), lengths).to(dtype)
        with pytest.raises(AssertionError):
            _close(ctl, plain.float().numpy(), dtype, 0.97, 1e-3, "the control")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hid,b,t", CASES)
def test_fwd_partition_matches_plain_and_fwd_xla(dtype, hid, b, t):
    """Kernel D's combos formed once and (bf16) its K split: hs, cs and gates
    against the plain forward and against ``_fwd_xla``."""
    xz, wc8, _, lengths = _inputs(t, b, hid, seed=hid * b)
    xz, wc8 = xz.to(dtype), wc8.to(dtype)
    got = _fwd_partition(xz, wc8, lengths)
    plain = qlstm_scan.qlstm_scan_fwd_plain(xz, wc8, lengths)
    fwd = jax.jit(jscan._fwd_xla)
    want = fwd(_j(xz, dtype), _j(wc8, dtype), _jax_mask(t, b, lengths, _JDT[dtype]))
    for name, g, p, w in zip(("hs", "cs", "gates"), got, plain, want):
        assert g.dtype == dtype, name
        _close(g, p.float().numpy(), dtype, 0.95, 1e-3, f"{name} against the plain version")
        _close(g, w.astype(jnp.float32), dtype, 0.95, 1e-3, f"{name} against _fwd_xla")
