"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips without an NVIDIA GPU. The file imports no
JAX, so it runs on a machine with the card and no JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py configures JAX.) Tolerances: f32
runs the kernels' CUDA-core path, where only the summation order differs
(1e-4); bf16 rounds the input and weight combos to bf16 before the f32
products (3e-2). In bf16 the rank-8 kernels (A, B, C) are held against the
plain version in bf16, whose input combos round as the kernels' and the JAX
package's do (each coefficient, each scaled term and the sum rounded to
bf16; ``test_rank8_combos_bit_exact_on_card``): three roundings a combo,
which the f32 plain version does not make, so against it the error grows
with the output's scale. The plain version in bf16 rounds each product to
bf16 before its f32 fold instead; within 3e-2 at these scales.
"""

import ctypes

import numpy as np
import pytest
import torch

from qasr_torch.ops.kernels import qconv_chain, qconv_dx, qconv_ft, qgemm, qgemm8, qlstm_scan


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(a)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# (5, 5): the largest kernel supported() admits fits shared memory in both dtypes
@pytest.mark.parametrize("kernel,t", [((3, 3), 70), ((3, 5), 33), ((5, 5), 20)])
def test_qconv_kernel_matches_plain_on_card(cuda_device, dtype, kernel, t):
    # f32: only the summation order differs; bf16: combos rounded to bf16
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=3e-2, atol=3e-2)
    rng = np.random.default_rng(1)
    x = _t(_rand(rng, 2, 4, 5, t, 16, scale=0.5)).to(cuda_device, dtype)
    w = _t(_rand(rng, 4, *kernel, 16, 24, scale=0.1)).to(cuda_device)
    bias = _t(_rand(rng, 96, scale=0.1)).to(cuda_device)
    alpha = _t(np.abs(_rand(rng, 64, scale=0.25))).to(cuda_device)
    before = qconv_ft.qconv_ft8.launches
    got = qconv_ft.qconv_ft8(x, w, bias, alpha)
    torch.cuda.synchronize()
    assert qconv_ft.qconv_ft8.launches == before + 1
    want = qconv_ft.qconv_stacked_plain(x, w, bias, alpha)  # in x's dtype
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(100, 72, 40), (7, 13, 62)])
def test_qgemm8_kernel_matches_plain_on_card(cuda_device, dtype, m, k, n):
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=3e-2, atol=3e-2)
    rng = np.random.default_rng(2)
    x4 = _t(_rand(rng, 4, m, k, scale=0.5)).to(cuda_device, dtype)
    w = _t(_rand(rng, 4, k, n, scale=0.2)).to(cuda_device)
    before = qgemm8.qgemm8_cl.launches
    got = qgemm8.qgemm8_cl(x4, w)
    torch.cuda.synchronize()
    assert qgemm8.qgemm8_cl.launches == before + 1
    want = qgemm8.qgemm8_cl_plain(x4, w)  # in x's dtype
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("kernel,t", [((3, 3), 70), ((3, 5), 33), ((5, 3), 20)])
def test_qconv_dx8_kernel_matches_plain_on_card(cuda_device, dtype, epilogue, kernel, t):
    """Kernel C: dx (and with the PReLU backward, dalpha, for signed slopes)
    against its plain version; 24 -> 16 channels, a ragged time tail."""
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=3e-2, atol=3e-2)
    rng = np.random.default_rng(3)
    dz = _t(_rand(rng, 2, 4, 5, t, 24, scale=0.5)).to(cuda_device, dtype)
    w = _t(_rand(rng, 4, *kernel, 16, 24, scale=0.1)).to(cuda_device)
    z = _t(_rand(rng, 2, 4, 5, t, 16, scale=0.5)).to(cuda_device, dtype) if epilogue else None
    alpha = _t(_rand(rng, 64, scale=0.25)).to(cuda_device) if epilogue else None
    before = qconv_dx.qconv_dx8.launches
    dx, dalpha = qconv_dx.qconv_dx8(dz, w, z, alpha)
    torch.cuda.synchronize()
    assert qconv_dx.qconv_dx8.launches == before + 1
    want_dx, want_da = qconv_dx.qconv_dx_plain(dz, w, z, alpha)  # in dz's dtype
    torch.testing.assert_close(dx.float(), want_dx.float(), **tol)
    if epilogue:
        # a sum over B*F*T: held relative to its largest element
        scale = want_da.abs().max().item()
        torch.testing.assert_close(dalpha, want_da, rtol=tol["rtol"], atol=tol["atol"] * scale)
    else:
        assert dalpha is None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(100, 72, 40), (7, 13, 62)])
def test_qgemm8_dx_kernel_matches_plain_on_card(cuda_device, dtype, m, k, n):
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=3e-2, atol=3e-2)
    rng = np.random.default_rng(4)
    dy4 = _t(_rand(rng, 4, m, n, scale=0.5)).to(cuda_device, dtype)
    w = _t(_rand(rng, 4, k, n, scale=0.2)).to(cuda_device)
    before = qgemm8.qgemm8_dx.launches
    got = qgemm8.qgemm8_dx(dy4, w)
    torch.cuda.synchronize()
    assert qgemm8.qgemm8_dx.launches == before + 1
    want = qgemm8.qgemm8_cl_plain(dy4, qgemm8.conj_transpose_dense(w))  # in dy's dtype
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("prologue", [False, True])
def test_autograd_functions_match_plain_autograd_on_card(cuda_device, prologue):
    """ChainLayerFn (kernels A and C) and QGemm8Fn (kernel B forward and dx)
    give the plain path's gradients in f32."""
    rng = np.random.default_rng(5)
    args = [_t(_rand(rng, 2, 4, 5, 21, 16, scale=0.5)), _t(_rand(rng, 4, 3, 5, 16, 8, scale=0.2)),
            _t(_rand(rng, 32, scale=0.1)), _t(_rand(rng, 64, scale=0.25))]
    dz = _t(_rand(rng, 2, 4, 5, 21, 8)).to(cuda_device)
    grads = []
    for plain in (False, True):
        ts = [a.to(cuda_device).requires_grad_() for a in args]
        z = qconv_chain.chain_layer(ts[0], ts[1], ts[2], ts[3] if prologue else None, plain=plain)
        z.backward(dz)
        grads.append([t.grad for t in ts])
    for got, want in zip(*grads):
        if want is None:
            assert got is None
        else:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    x4, w = _t(_rand(rng, 4, 30, 24, scale=0.5)), _t(_rand(rng, 4, 24, 16, scale=0.2))
    dy = _t(_rand(rng, 4, 30, 16)).to(cuda_device)
    grads = []
    for plain in (False, True):
        ts = [a.to(cuda_device).requires_grad_() for a in (x4, w)]
        qgemm8.qgemm8_cl(ts[0], ts[1], plain=plain).backward(dy)
        grads.append([t.grad for t in ts])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(64, 3328, 256), (16, 1024, 1024)])
def test_qgemm8_fn_dw_branches_on_card(cuda_device, m, k, n):
    """Both dW formulations of QGemm8Fn run on the card: block at
    k*n < 2**20 (the model's 3328 x 256), rank-8 at k*n >= 2**20; each
    against the plain path's autograd in f32."""
    rng = np.random.default_rng(6)
    x4, w = _t(_rand(rng, 4, m, k, scale=0.5)), _t(_rand(rng, 4, k, n, scale=0.02))
    dy = _t(_rand(rng, 4, m, n)).to(cuda_device)
    grads = []
    for plain in (False, True):
        ts = [a.to(cuda_device).requires_grad_() for a in (x4, w)]
        qgemm8.qgemm8_cl(ts[0], ts[1], plain=plain).backward(dy)
        grads.append([t.grad for t in ts])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# ragged B and T; B=40 spans several row tiles; H=256 is config 4's full grid;
# H=16 the smallest grid (kernel E: two blocks a direction), H=48 the
# products' partial warps
@pytest.mark.parametrize("b,t,hid,use_lengths",
                         [(3, 17, 32, True), (3, 17, 32, False), (40, 9, 48, True), (2, 5, 256, True),
                          (40, 7, 16, True), (40, 6, 48, False), (40, 5, 256, True)])
def test_qlstm_scan_kernel_matches_plain_on_card(cuda_device, dtype, b, t, hid, use_lengths):
    """Kernel D: hs, cs and gates against its plain version on signed inputs,
    in the same dtype (both carry h and c in it); two runs give the same
    bits."""
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=3e-2, atol=3e-2)
    rng = np.random.default_rng(7)
    xz = _t(_rand(rng, t, 2, b, 16 * hid, scale=0.5)).to(cuda_device, dtype)
    wc8 = _t(_rand(rng, 2, 8, hid, 4 * hid, scale=hid ** -0.5)).to(cuda_device, dtype)
    lengths = None
    if use_lengths:
        lengths = torch.from_numpy(rng.integers(1, t + 1, size=b)).to(cuda_device)
        lengths[0] = t
    before = qlstm_scan.qlstm_scan_fast8.launches
    got = qlstm_scan.qlstm_scan_fwd(xz, wc8, lengths)
    again = qlstm_scan.qlstm_scan_fwd(xz, wc8, lengths)
    torch.cuda.synchronize()
    assert qlstm_scan.qlstm_scan_fast8.launches == before + 2
    want = qlstm_scan.qlstm_scan_fwd_plain(xz, wc8, lengths)
    for name, g, a, w in zip(("hs", "cs", "gates"), got, again, want):
        assert torch.equal(g, a), name
        torch.testing.assert_close(g.float(), w.float(), msg=name, **tol)
    # the public wrapper: component-major xz in, hs out
    hs = qlstm_scan.qlstm_scan_fast8(qlstm_scan.to_gate_major(xz), wc8, lengths)
    # to_gate_major is its own inverse (a 4x4 transpose of [q, g])
    assert torch.equal(hs, got[0])


@pytest.mark.cuda
def test_qlstm_scan_kernel_refuses_on_card(cuda_device):
    """Past supported()'s bound kernels D and E raise instead of running the
    plain version. With grad required, kernel D runs through QLstmScanFn
    and kernel E launches once on its backward."""
    bf16 = torch.bfloat16
    before = qlstm_scan.qlstm_scan_fast8.launches, qlstm_scan.qlstm_scan_bwd.launches
    xz = torch.zeros((2, 2, 1, 16 * 272), dtype=bf16, device=cuda_device)
    wc8 = torch.zeros((2, 8, 272, 4 * 272), dtype=bf16, device=cuda_device)
    with pytest.raises(ValueError, match="does not support hidden=272"):
        qlstm_scan.qlstm_scan_fwd(xz, wc8)
    h4 = torch.zeros((2, 2, 1, 4 * 272), dtype=bf16, device=cuda_device)
    with pytest.raises(ValueError, match="does not support hidden=272"):
        qlstm_scan.qlstm_scan_bwd(wc8, xz, h4, h4)
    xz = torch.zeros((2, 2, 1, 16 * 256), dtype=bf16, device=cuda_device)
    wc8 = torch.zeros((2, 8, 256, 4 * 256), dtype=bf16, device=cuda_device, requires_grad=True)
    hs, _, _ = qlstm_scan.qlstm_scan_fwd(xz, wc8)
    assert type(hs.grad_fn).__name__ == "QLstmScanFnBackward"
    hs.float().sum().backward()
    torch.cuda.synchronize()
    assert wc8.grad is not None and wc8.grad.dtype == bf16
    with torch.no_grad():
        qlstm_scan.qlstm_scan_fwd(xz, wc8)
    torch.cuda.synchronize()
    assert (qlstm_scan.qlstm_scan_fast8.launches - before[0],
            qlstm_scan.qlstm_scan_bwd.launches - before[1]) == (2, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# ragged B and T; B=40 spans two row tiles; H=256 is config 4's full grid;
# H=16 the smallest grid (two blocks a direction), H=48 the products'
# partial warps
@pytest.mark.parametrize("b,t,hid,use_lengths",
                         [(3, 17, 32, True), (3, 17, 32, False), (40, 9, 48, True), (2, 5, 256, True),
                          (40, 7, 16, True), (40, 6, 48, False), (40, 5, 256, True)])
def test_qlstm_scan_bwd_kernel_matches_plain_on_card(cuda_device, dtype, b, t, hid, use_lengths):
    """Kernel E: dz against its plain version on the residuals of a forward,
    signed dhs, in the same dtype (both carry dh and dc in f32 and round
    dprods and dz at the same places); two runs give the same bits."""
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=3e-2, atol=3e-2)
    rng = np.random.default_rng(8)
    xz = _t(_rand(rng, t, 2, b, 16 * hid, scale=0.5)).to(cuda_device, dtype)
    wc8 = _t(_rand(rng, 2, 8, hid, 4 * hid, scale=hid ** -0.5)).to(cuda_device, dtype)
    dhs = _t(_rand(rng, t, 2, b, 4 * hid)).to(cuda_device, dtype)
    lengths = None
    if use_lengths:
        lengths = torch.from_numpy(rng.integers(1, t + 1, size=b)).to(cuda_device)
        lengths[0] = t
    with torch.no_grad():
        _, cs, gates = qlstm_scan.qlstm_scan_fwd(xz, wc8, lengths)
    before = qlstm_scan.qlstm_scan_bwd.launches
    got = qlstm_scan.qlstm_scan_bwd(wc8, gates, cs, dhs, lengths)
    again = qlstm_scan.qlstm_scan_bwd(wc8, gates, cs, dhs, lengths)
    torch.cuda.synchronize()
    assert qlstm_scan.qlstm_scan_bwd.launches == before + 2
    assert got.dtype == dtype and torch.equal(got, again)
    want = qlstm_scan.qlstm_scan_bwd_plain(wc8, gates, cs, dhs, lengths)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
def test_qlstm_scan_bwd_refusal_edge_on_card(cuda_device):
    """supported()'s edge on this card: the largest admitted hidden size runs
    kernel E in both dtypes; the next multiple of 16 raises."""
    sms = qlstm_scan.device_sms(cuda_device)
    top = max(h for h in range(16, 1024, 16) if qlstm_scan.supported(h, torch.bfloat16, sms))
    for dtype in (torch.float32, torch.bfloat16):
        for hid, ok in ((top, True), (top + 16, False)):
            z16 = torch.zeros((2, 2, 1, 16 * hid), dtype=dtype, device=cuda_device)
            z4 = torch.zeros((2, 2, 1, 4 * hid), dtype=dtype, device=cuda_device)
            wc8 = torch.zeros((2, 8, hid, 4 * hid), dtype=dtype, device=cuda_device)
            if ok:
                dz = qlstm_scan.qlstm_scan_bwd(wc8, z16, z4, z4)
                torch.cuda.synchronize()
                assert not dz.any()
            else:
                with pytest.raises(ValueError, match=f"does not support hidden={hid}"):
                    qlstm_scan.qlstm_scan_bwd(wc8, z16, z4, z4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qlstm_scan_fn_kernel_path_matches_plain_path_on_card(cuda_device, dtype):
    """QLstmScanFn on the kernel path (D forward, E backward, the dW einsums)
    against the same Function on the plain path: hs, dxz and dwc8, ragged
    lengths. bf16: both round at the same places (3e-2, as the kernels)."""
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=3e-2, atol=3e-2)
    b, t, hid = 5, 13, 32
    rng = np.random.default_rng(9)
    xz = _t(_rand(rng, t, 2, b, 16 * hid, scale=0.5)).to(cuda_device, dtype)
    wc8 = _t(_rand(rng, 2, 8, hid, 4 * hid, scale=hid ** -0.5)).to(cuda_device, dtype)
    cot = _t(_rand(rng, t, 2, b, 4 * hid)).to(cuda_device, dtype)
    lengths = torch.tensor([13, 2, 9, 13, 5], device=cuda_device)
    outs = []
    for plain in (False, True):
        x, w = xz.clone().requires_grad_(), wc8.clone().requires_grad_()
        hs = qlstm_scan.qlstm_scan_fast8(x, w, lengths, plain=plain)
        hs.backward(cot)
        outs.append((hs.detach(), x.grad, w.grad))
    torch.cuda.synchronize()
    for name, got, want in zip(("hs", "dxz", "dwc8"), *outs):
        assert got.dtype == dtype, name
        # dW sums over T*B rows: held relative to its largest element
        scale = want.abs().max().item() if name == "dwc8" else 1.0
        torch.testing.assert_close(got.float(), want.float(), rtol=tol["rtol"],
                                   atol=tol["atol"] * scale, msg=name)


# ---------------------------------------------------------------------------
# the 10-product kernels: F (conv), G (its transpose), H (GEMM, both roles),
# I (the GEMM's dW)
# ---------------------------------------------------------------------------


def _tol(dtype):
    return dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=3e-2, atol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("kernel,t", [((3, 3), 70), ((3, 5), 33), ((5, 5), 20)])
def test_qconv_ft10_kernel_matches_plain_on_card(cuda_device, dtype, prologue, kernel, t):
    """Kernel F, with and without the PReLU prologue and bias, against its
    plain version; 16 -> 24 channels, a ragged time tail."""
    rng = np.random.default_rng(11)
    x = _t(_rand(rng, 2, 4, 5, t, 16, scale=0.5)).to(cuda_device, dtype)
    w = _t(_rand(rng, 4, *kernel, 16, 24, scale=0.1)).to(cuda_device)
    bias = _t(_rand(rng, 96, scale=0.1)).to(cuda_device) if prologue else None
    alpha = _t(np.abs(_rand(rng, 64, scale=0.25))).to(cuda_device) if prologue else None
    before = qconv_ft.qconv_ft10.launches
    got = qconv_ft.qconv_ft10(x, w, bias, alpha)
    torch.cuda.synchronize()
    assert qconv_ft.qconv_ft10.launches == before + 1
    want = qconv_ft.qconv_stacked_plain(x.float(), w, bias, alpha, scheme=qconv_ft.SCHEME10)
    torch.testing.assert_close(got.float(), want, **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("kernel,t", [((3, 3), 70), ((3, 5), 33), ((5, 3), 20)])
def test_qconv_dx10_kernel_matches_plain_on_card(cuda_device, dtype, epilogue, kernel, t):
    """Kernel G: dx (and with the PReLU backward, dalpha, for signed slopes)
    against its plain version, and dx without the epilogue against the
    TPU's rotated-role formulation; 24 -> 16 channels, a ragged time tail."""
    tol = _tol(dtype)
    rng = np.random.default_rng(12)
    dz = _t(_rand(rng, 2, 4, 5, t, 24, scale=0.5)).to(cuda_device, dtype)
    w = _t(_rand(rng, 4, *kernel, 16, 24, scale=0.1)).to(cuda_device)
    z = _t(_rand(rng, 2, 4, 5, t, 16, scale=0.5)).to(cuda_device, dtype) if epilogue else None
    alpha = _t(_rand(rng, 64, scale=0.25)).to(cuda_device) if epilogue else None
    before = qconv_dx.qconv_dx10.launches
    dx, dalpha = qconv_dx.qconv_dx10(dz, w, z, alpha)
    again = qconv_dx.qconv_dx10(dz, w, z, alpha)
    torch.cuda.synchronize()
    assert qconv_dx.qconv_dx10.launches == before + 2
    assert torch.equal(dx, again[0])
    want_dx, want_da = qconv_dx.qconv_dx_plain(
        dz.float(), w, None if z is None else z.float(), alpha, scheme=qconv_ft.SCHEME10
    )
    torch.testing.assert_close(dx.float(), want_dx, **tol)
    if epilogue:
        assert torch.equal(dalpha, again[1])
        scale = want_da.abs().max().item()
        torch.testing.assert_close(dalpha, want_da, rtol=tol["rtol"], atol=tol["atol"] * scale)
    else:
        assert dalpha is None
        rot = qconv_dx.qconv_dx10_rotated_plain(dz.float(), w)
        torch.testing.assert_close(dx.float(), rot, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["F", "F prologue+bias", "G", "G epilogue",
                                    "A", "A prologue+bias", "C", "C epilogue"])
# Cin not a multiple of the 32-deep chunk and Cout not of the 64-wide tile
# (G chunks over 72 and tiles over 40); F = 1, where only the centre
# frequency tap is in range; T below one tile and over several; 3x5 and 5x5
# kernels (one window buffer at five frequency taps); config 4's stacked
# layers (64 -> 64: one N tile, two chunks; 64 -> 128; 128 -> 128) at F13
# T512; the config-2 path's 256 -> 256
@pytest.mark.parametrize("b,nf,t,cin,cout,kernel_size", [
    (2, 5, 70, 40, 72, (3, 3)), (2, 1, 100, 48, 64, (3, 3)), (3, 4, 5, 64, 64, (3, 3)),
    (2, 3, 200, 64, 128, (3, 3)), (2, 5, 33, 40, 24, (3, 5)), (2, 5, 20, 16, 72, (5, 5)),
    (2, 13, 512, 64, 64, (3, 3)), (2, 13, 512, 64, 128, (3, 3)),
    (2, 13, 512, 128, 128, (3, 3)), (2, 13, 256, 256, 256, (3, 3))])
def test_qconv10_main_loop_edges_on_card(cuda_device, kernel, b, nf, t, cin, cout, kernel_size):
    """qconv.cuh's wgmma loop in bf16, in both schemes (kernels F and G,
    P = 10; A and C, P = 8), through the wrappers, with and without the
    forward's PReLU prologue and bias and the transpose's PReLU-backward
    epilogue (dalpha too, for signed slopes), against the plain versions at
    today's tolerance (F and G in f32; A and C in bf16, as the module's
    docstring says), and the same bits twice."""
    tol = _tol(torch.bfloat16)
    rng = np.random.default_rng(22)
    kh, kw = kernel_size
    scheme = qconv_ft.SCHEME8 if kernel[0] in "AC" else qconv_ft.SCHEME10
    fwd = qconv_ft.qconv_ft8 if scheme is qconv_ft.SCHEME8 else qconv_ft.qconv_ft10
    bwd = qconv_dx.qconv_dx8 if scheme is qconv_ft.SCHEME8 else qconv_dx.qconv_dx10
    # the plain version's dtype: bf16 for the rank-8 kernels
    ref = (lambda v: v) if scheme is qconv_ft.SCHEME8 else (lambda v: None if v is None else v.float())
    w = _t(_rand(rng, 4, kh, kw, cin, cout, scale=(kh * kw * cin) ** -0.5)).to(cuda_device)
    if kernel[0] in "AF":
        x = _t(_rand(rng, b, 4, nf, t, cin, scale=0.5)).to(cuda_device, torch.bfloat16)
        bias = _t(_rand(rng, 4 * cout, scale=0.1)).to(cuda_device) if "prologue" in kernel else None
        alpha = (_t(np.abs(_rand(rng, 4 * cin, scale=0.25))).to(cuda_device)
                 if "prologue" in kernel else None)
        before = fwd.launches
        got = fwd(x, w, bias, alpha)
        again = fwd(x, w, bias, alpha)
        torch.cuda.synchronize()
        assert fwd.launches == before + 2
        assert got.shape == (b, 4, nf, t, cout) and torch.equal(got, again)
        want = qconv_ft.qconv_stacked_plain(ref(x), w, bias, alpha, scheme=scheme)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        return
    dz = _t(_rand(rng, b, 4, nf, t, cout, scale=0.5)).to(cuda_device, torch.bfloat16)
    epi = kernel.endswith("epilogue")
    z = _t(_rand(rng, b, 4, nf, t, cin, scale=0.5)).to(cuda_device, torch.bfloat16) if epi else None
    alpha = _t(_rand(rng, 4 * cin, scale=0.25)).to(cuda_device) if epi else None
    before = bwd.launches
    dx, dalpha = bwd(dz, w, z, alpha)
    dx2, dalpha2 = bwd(dz, w, z, alpha)
    torch.cuda.synchronize()
    assert bwd.launches == before + 2
    assert dx.shape == (b, 4, nf, t, cin) and torch.equal(dx, dx2)
    want_dx, want_da = qconv_dx.qconv_dx_plain(ref(dz), w, ref(z), alpha, scheme=scheme)
    torch.testing.assert_close(dx.float(), want_dx.float(), **tol)
    if epi:
        assert torch.equal(dalpha, dalpha2)
        scale = want_da.abs().max().item()
        torch.testing.assert_close(dalpha, want_da, rtol=tol["rtol"], atol=tol["atol"] * scale)
    else:
        assert dalpha is None


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["A", "C", "B"])
@pytest.mark.parametrize("p", range(8))
def test_rank8_combos_bit_exact_on_card(cuda_device, kernel, p):
    """The rank-8 kernels' input combos (``combo2`` in ``qtile.cuh``) equal
    the plain versions' (``qconv_ft._combo``, ``qgemm8.combos8``, the JAX
    package's rounding) bit for bit. The weight combos are product p's
    identity (the conv's centre tap), the rest zero, so each output is
    ``O8[b, p] * combo_p`` rounded once to bf16: every other term the
    kernel adds is an exact zero."""
    rng = np.random.default_rng(30 + p)
    bf16 = torch.bfloat16
    o8 = _t(qconv_ft._O8_F32).to(cuda_device)
    c = 72  # past a 64-wide tile and a 32-deep chunk
    if kernel == "B":
        m = 300
        x4 = _rand(rng, 4, m, c) * 2.0 ** rng.integers(-6, 6, (4, m, c))
        x4 = _t(x4.astype(np.float32)).to(cuda_device, bf16)
        wc8 = torch.zeros(8, c, c, device=cuda_device, dtype=bf16)
        wc8[p] = torch.eye(c, device=cuda_device, dtype=bf16)
        got = qgemm8.qgemm8_cuda(x4, wc8)
        combo = qgemm8.combos8(x4)[p]
    else:
        x = _rand(rng, 2, 4, 5, 70, c) * 2.0 ** rng.integers(-6, 6, (2, 4, 5, 70, c))
        x = _t(x.astype(np.float32)).to(cuda_device, bf16)
        wc = torch.zeros(8, 3, 3, c, c, device=cuda_device, dtype=bf16)
        wc[p, 1, 1] = torch.eye(c, device=cuda_device, dtype=bf16)
        if kernel == "A":
            got = qconv_ft.qconv_ft_cuda(x, wc)
        else:
            got = qconv_dx.qconv_dx_cuda(x, wc)[0]
        combo = qconv_ft._combo(x, qconv_ft.SCHEME8.fwd_in[p])
    torch.cuda.synchronize()
    want = torch.stack([(o8[b, p] * combo.float()).to(bf16) for b in range(4)],
                       dim=0 if kernel == "B" else 1)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["qasr_qconv_ft8", "qasr_qconv_dx8"])
@pytest.mark.parametrize("edit", ["rows swapped", "a zero coefficient"])
def test_rank8_wg_loop_refuses_other_schemes_on_card(cuda_device, entry, edit):
    """Kernels A and C in bf16 compile V8's terms in: handed a rank-8 table
    whose terms differ, the entry returns cudaErrorInvalidValue (the wrapper
    then raises); nothing falls back to another loop."""
    from qasr_torch.ops.kernels import _build

    lib = _build.load_library()
    v = qconv_ft._V8_F32.copy()
    if edit == "rows swapped":
        v[[0, 1]] = v[[1, 0]]
    else:
        v[2, np.flatnonzero(v[2])[0]] = 0.0
    v = np.ascontiguousarray(v)
    o = qconv_ft._O8_F32
    b, nf, t, ch = 1, 3, 64, 32
    x = torch.ones(b, 4, nf, t, ch, device=cuda_device, dtype=torch.bfloat16)
    wc = torch.zeros(8, 3, 3, ch, ch, device=cuda_device, dtype=torch.bfloat16)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    vp, op = v.ctypes.data_as(ctypes.c_void_p), o.ctypes.data_as(ctypes.c_void_p)
    if entry == "qasr_qconv_ft8":
        err = lib.qasr_qconv_ft8(x.data_ptr(), wc.data_ptr(), None, None, out.data_ptr(),
                                 b, nf, t, ch, ch, 3, 3, 1, vp, op, stream)
    else:
        err = lib.qasr_qconv_dx8(x.data_ptr(), wc.data_ptr(), None, None, out.data_ptr(),
                                 None, None, b, nf, t, ch, ch, 3, 3, 1, vp, op, stream)
    assert err == 1  # cudaErrorInvalidValue
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        _build.check(lib, err, entry)
    # the V8 table itself launches
    err = lib.qasr_qconv_ft8(x.data_ptr(), wc.data_ptr(), None, None, out.data_ptr(),
                             b, nf, t, ch, ch, 3, 3, 1,
                             qconv_ft._V8_F32.ctypes.data_as(ctypes.c_void_p), op, stream)
    torch.cuda.synchronize()
    assert err == 0 and not out.any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(100, 72, 40), (7, 13, 62)])
def test_qgemm10_kernel_matches_plain_on_card(cuda_device, dtype, m, k, n):
    """Kernel H in both roles: forward, and dx on the conj-transposed
    weights, against its plain version; ragged K and N are padded."""
    rng = np.random.default_rng(13)
    x4 = _t(_rand(rng, 4, m, k, scale=0.5)).to(cuda_device, dtype)
    dy4 = _t(_rand(rng, 4, m, n, scale=0.5)).to(cuda_device, dtype)
    w = _t(_rand(rng, 4, k, n, scale=0.2)).to(cuda_device)
    f0, d0 = qgemm.qgemm10.launches, qgemm.qgemm10_dx.launches
    got = qgemm.qgemm10(x4, w)
    got_dx = qgemm.qgemm10_dx(dy4, w)
    torch.cuda.synchronize()
    assert (qgemm.qgemm10.launches, qgemm.qgemm10_dx.launches) == (f0 + 1, d0 + 1)
    torch.testing.assert_close(got.float(), qgemm.qgemm_stacked_plain(x4.float(), w), **_tol(dtype))
    want_dx = qgemm.qgemm_stacked_plain(dy4.float(), qgemm8.conj_transpose_dense(w))
    torch.testing.assert_close(got_dx.float(), want_dx, **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel,role", [("B", "fwd"), ("B", "dx"), ("H", "fwd"), ("H", "dx")])
# M past a whole number of tiles and of a cluster's rows (18 tiles), M below
# one tile, K a multiple of 8 but not of the 32-deep chunk, N a multiple of
# 8 but not of the 64-wide tile, and whole tiles
@pytest.mark.parametrize("m,k,n", [(1100, 200, 136), (5, 40, 72), (4096, 256, 256)])
def test_qgemm_main_loop_edges_on_card(cuda_device, dtype, kernel, role, m, k, n):
    """qgemm.cuh's main loop (kernel B, P = 8, and H, P = 10) through the
    wrappers, both roles, against the plain versions at today's
    tolerances, and the same bits twice."""
    rng = np.random.default_rng(21)
    w = _t(_rand(rng, 4, k, n, scale=k ** -0.5)).to(cuda_device)
    if role == "fwd":
        inp = _t(_rand(rng, 4, m, k, scale=0.5)).to(cuda_device, dtype)
        ww = w
    else:
        inp = _t(_rand(rng, 4, m, n, scale=0.5)).to(cuda_device, dtype)
        ww = qgemm8.conj_transpose_dense(w)
    fns = {("B", "fwd"): qgemm8.qgemm8_cl, ("B", "dx"): qgemm8.qgemm8_dx,
           ("H", "fwd"): qgemm.qgemm10, ("H", "dx"): qgemm.qgemm10_dx}
    fn = fns[kernel, role]
    plain = qgemm8.qgemm8_cl_plain if kernel == "B" else qgemm.qgemm_stacked_plain
    before = fn.launches
    got = fn(inp, w)
    again = fn(inp, w)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert got.shape == (4, m, ww.shape[2])
    torch.testing.assert_close(got.float(), plain(inp.float(), ww), **_tol(dtype))
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(300, 72, 40), (1000, 13, 62), (256, 136, 200),
                                   (4096, 256, 256), (3990, 256, 256), (2000, 200, 136),
                                   (300, 1024, 1024)])
def test_qgemm10_dw_kernel_matches_plain_on_card(cuda_device, dtype, m, k, n):
    """Kernel I against its plain version: ragged M (its last chunk masked),
    K and N ragged (padded) and over several tiles; M split into S > 1 runs
    (the dense layers' M4096 K256 N256; M3990, whose last run is shorter and
    ends in a masked chunk; K200 N136, partial tiles) and one pass where
    the tiles fill a wave (K = N = 1024); a sum over M, held relative to its
    largest element; two runs give the same bits."""
    tol = _tol(dtype)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    s = qgemm.dw_splits(m, -(-k // 8) * 8, -(-n // 8) * 8, dtype, sms)
    assert (s == 1) == (k == 1024)
    rng = np.random.default_rng(14)
    x4 = _t(_rand(rng, 4, m, k, scale=0.5)).to(cuda_device, dtype)
    dy4 = _t(_rand(rng, 4, m, n, scale=0.5)).to(cuda_device, dtype)
    before = qgemm.qgemm10_dw.launches
    got = qgemm.qgemm10_dw(x4, dy4)
    again = qgemm.qgemm10_dw(x4, dy4)
    torch.cuda.synchronize()
    assert qgemm.qgemm10_dw.launches == before + 2
    assert got.dtype == torch.float32 and torch.equal(got, again)
    want = qgemm.qgemm_dw_plain(x4, dy4)
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=tol["rtol"], atol=tol["atol"] * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [30, 300])
def test_10_product_functions_match_plain_autograd_on_card(cuda_device, m):
    """ChainLayerFn in fast10 (kernels F and G) and QGemmFn (kernel H both
    roles; kernel I at M >= 256, the 16-product einsum below) give the plain
    path's gradients in f32."""
    rng = np.random.default_rng(15)
    args = [_t(_rand(rng, 2, 4, 5, 21, 16, scale=0.5)), _t(_rand(rng, 4, 3, 5, 16, 8, scale=0.2)),
            _t(_rand(rng, 32, scale=0.1)), _t(_rand(rng, 64, scale=0.25))]
    dz = _t(_rand(rng, 2, 4, 5, 21, 8)).to(cuda_device)
    grads = []
    for plain in (False, True):
        ts = [a.to(cuda_device).requires_grad_() for a in args]
        qconv_chain.chain_layer(*ts, scheme="fast10", plain=plain).backward(dz)
        grads.append([t.grad for t in ts])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    x4, w = _t(_rand(rng, 4, m, 24, scale=0.5)), _t(_rand(rng, 4, 24, 16, scale=0.2))
    dy = _t(_rand(rng, 4, m, 16)).to(cuda_device)
    grads = []
    for plain in (False, True):
        ts = [a.to(cuda_device).requires_grad_() for a in (x4, w)]
        qgemm.qgemm_stacked(ts[0], ts[1], plain=plain).backward(dy)
        grads.append([t.grad for t in ts])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1000, 72, 40), (4096, 256, 256), (777, 64, 136),
                                   (65576, 256, 256), (40, 8, 8), (1000, 264, 136),
                                   (4096, 512, 520)])
def test_dgt_kernel_matches_plain_on_card(cuda_device, dtype, m, k, n):
    """Kernel J against its plain version in both modes (``"plain"`` where M
    is a multiple of 8): ragged M (the last chunk zero-filled; M 40 under one
    bf16 chunk), K and N over partial tiles (bf16's 128 x 256: K 264 and N
    136 leave a tile with one box of K and N, N 520 a box wholly past N);
    pairs of runs (even S) and single runs (S 1); a sum over M, held
    relative to its largest element; the two modes and two runs give the
    same bits."""
    from qasr_torch.ops.kernels import dgt

    tol = _tol(dtype)
    rng = np.random.default_rng(16)
    x = _t(_rand(rng, m, k)).to(cuda_device, dtype)
    y = _t(_rand(rng, m, n)).to(cuda_device, dtype)
    before = dgt.dgt.launches
    got = dgt.dgt(x, y, mode="dgt")
    again = dgt.dgt(x, y, mode="dgt")
    modes = ("dgt", "plain") if dgt.supported(m, k, n, dtype, "plain") else ("dgt",)
    if "plain" in modes:
        assert torch.equal(dgt.dgt(x.T.contiguous(), y, mode="plain"), got)
    torch.cuda.synchronize()
    assert dgt.dgt.launches == before + 1 + len(modes)
    assert got.dtype == dtype and got.shape == (k, n) and torch.equal(got, again)
    want = dgt.dgt_plain(x, y, mode="dgt").float()
    scale = want.abs().max().item()
    torch.testing.assert_close(got.float(), want, rtol=tol["rtol"], atol=tol["atol"] * scale)


@pytest.mark.cuda
def test_dgt_kernel_refuses_on_card(cuda_device):
    """Shapes kernel J does not take raise; nothing falls back."""
    from qasr_torch.ops.kernels import dgt

    x = torch.zeros(64, 12, device=cuda_device)
    with pytest.raises(ValueError, match="does not take"):
        dgt.dgt(x, torch.zeros(64, 8, device=cuda_device), mode="dgt")
    with pytest.raises(ValueError, match="does not take"):
        dgt.dgt(torch.zeros(8, 60, device=cuda_device), torch.zeros(60, 8, device=cuda_device),
                mode="plain")
    with pytest.raises(ValueError, match="does not take"):
        dgt.dgt(torch.zeros(64, 8, device=cuda_device, dtype=torch.float16),
                torch.zeros(64, 8, device=cuda_device, dtype=torch.float16), mode="dgt")
    with pytest.raises(ValueError, match="contiguous"):
        dgt.dgt(torch.zeros(8, 64, device=cuda_device).T, torch.zeros(64, 8, device=cuda_device),
                mode="dgt")


@pytest.mark.cuda
@pytest.mark.parametrize("prune", [None, -20.0])
def test_beam_on_card_matches_cpu_and_host_beam(cuda_device, prune):
    """The prefix beam on the card (plain PyTorch, no kernel of its own)
    against itself on the CPU and against the native host beam, at W=100,
    V=62 with ragged lengths: sequences and lengths equal, scores 1e-3 (the
    card's exp and log are other implementations; a few ulp a frame)."""
    from qasr_torch.decode import ctc_beam_search_decode, ctc_beam_search_decode_host

    rng = np.random.default_rng(31)
    logits = _t(_rand(rng, 4, 60, 62, scale=2.0))
    lengths = torch.tensor([60, 51, 17, 0])
    kw = dict(beam_width=100, max_len=60, prune_logp=prune)
    got = ctc_beam_search_decode(logits.to(cuda_device), lengths.to(cuda_device), **kw)
    assert all(t.device.type == "cuda" for t in got)
    want = ctc_beam_search_decode(logits, lengths, **kw)
    host = ctc_beam_search_decode_host(logits, lengths, **kw)
    for ref in (want, [torch.from_numpy(a) for a in host]):
        assert torch.equal(got[1].cpu(), ref[1].to(torch.int32))
        assert torch.equal(got[0].cpu(), ref[0].to(torch.int32))
        torch.testing.assert_close(got[2].cpu(), ref[2].float(), rtol=1e-3, atol=1e-3)
