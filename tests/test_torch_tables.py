"""The scheme tables (V8, O8, U8, X_COMBO, W_COMBO, OUT_COMBO, the Hamilton
tables) become tensors once per (table, dtype, device): after a first call
the GEMM wrappers turn no numpy array into a tensor, since on the card each
such conversion is a host-to-device copy that synchronises the stream. The
cached tensors hold the numpy tables' values exactly.
"""

import numpy as np
import pytest
import torch

from qasr_torch.ops import quaternion
from qasr_torch.ops.kernels.qgemm import qgemm_stacked
from qasr_torch.ops.kernels.qgemm8 import qdense_pallas8, qgemm8_cl, qgemm8_dx

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_second_call_converts_no_table(monkeypatch, dtype):
    monkeypatch.setattr(quaternion, "_DEVICE_TABLES", {})
    converted = []
    as_tensor = torch.as_tensor

    def counting(data, *args, **kwargs):
        if isinstance(data, np.ndarray):
            converted.append(data.shape)
        return as_tensor(data, *args, **kwargs)

    monkeypatch.setattr(torch, "as_tensor", counting)
    rng = np.random.default_rng(0)
    x4 = torch.from_numpy(rng.standard_normal((4, 300, 24)).astype(np.float32)).to(dtype)
    dy4 = torch.from_numpy(rng.standard_normal((4, 300, 16)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal((4, 24, 16)).astype(np.float32) * 0.2)
    x = torch.from_numpy(rng.standard_normal((2, 5, 96)).astype(np.float32)).to(dtype)

    def calls():
        qgemm8_cl(x4, w)
        qgemm8_dx(dy4, w)
        w10 = w.clone().requires_grad_(True)
        x10 = x4.clone().requires_grad_(True)
        qgemm_stacked(x10, w10).float().sum().backward()  # M 300: dW on the 10-product form
        qgemm_stacked(x10[:, :20], w10).float().sum().backward()  # M 20: the 16-product einsum
        qdense_pallas8(x, w)

    calls()
    first = len(converted)
    assert first > 0
    calls()
    assert len(converted) == first, f"the second call converted {converted[first:]}"
    for table, tensor in quaternion._DEVICE_TABLES.values():
        assert torch.equal(tensor, torch.from_numpy(np.array(table)).to(tensor.dtype))
