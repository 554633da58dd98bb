"""The two CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips without an NVIDIA GPU. The file imports no
JAX, so it runs on a machine with the card and no JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py configures JAX.) Tolerances: f32
runs the kernels' CUDA-core path, where only the summation order differs
(1e-4); bf16 rounds the input and weight combos to bf16 before the f32
products (3e-2).
"""

import numpy as np
import pytest
import torch

from qasr_torch.ops.kernels import qconv_ft, qgemm8


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
    want = qconv_ft.qconv_fast8_stacked_plain(x.float(), w, bias, alpha)
    torch.testing.assert_close(got.float(), want, **tol)


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
    want = qgemm8.qgemm8_cl_plain(x4.float(), w)
    torch.testing.assert_close(got.float(), want, **tol)
