"""The port's utilities (``qasr_torch.utils``) against the JAX package's
(``qasr.utils``): the timing harness and the FLOP count give the same
numbers on the same inputs, the roofline returns the same keys, the chip
table holds the card's datasheet figures only, and the numerics hooks trap
what they say they trap.
"""

import os

import numpy as np
import pytest
import torch

from qasr.utils import profiling as jprofiling
from qasr_torch import utils
from qasr_torch.utils import debug, profiling

torch.set_num_threads(1)

# A scripted run: the wall seconds a chain of n steps "took", with a fixed
# cost, a per-step cost and a drift that changes from call to call.
_SCRIPT = [0.013, 0.002, -0.004, 0.021, 0.0, 0.007, -0.011, 0.003, 0.017, -0.002, 0.009, 0.001]


def _scripted(per_step, fixed=0.03):
    calls = iter(_SCRIPT * 4)
    return lambda n: fixed + per_step * n + next(calls)


def test_steady_state_times_equal_jax():
    """The same difference quotients, interleaving and medians as
    ``qasr.utils.profiling.steady_state_times``, per-arm chain lengths
    included."""
    for kw in ({}, {"n_small": 3, "n_big": 40, "repeats": 5}):
        def runs():
            return {"a": _scripted(1e-3), "b": (_scripted(2.5e-4, 0.1), (2, 12))}

        assert profiling.steady_state_times(runs(), **kw) == \
            jprofiling.steady_state_times(runs(), **kw)
    assert profiling.steady_state_time(_scripted(4e-4), repeats=5) == \
        jprofiling.steady_state_time(_scripted(4e-4), repeats=5)


@pytest.mark.parametrize("shape", [(16, 256, 13, 256, 256), (2, 7, 5, 3, 9, 5, 3)])
def test_qconv_flops_equal_jax(shape):
    assert profiling.qconv_flops(*shape) == jprofiling.qconv_flops(*shape)


def test_chips_hold_the_h100_only():
    """The card's datasheet figures, not a TPU's rates."""
    assert set(utils.CHIPS) == {"h100"}
    assert utils.CHIPS["h100"] == utils.ChipSpec("h100", 989.0, 3350.0)


def test_conv_roofline_keys_and_refusals():
    """At a tiny shape on the host (its times are the host's, not a device
    metric) the block path returns the JAX function's keys; the packed XLA
    arms raise."""
    kw = dict(batch=1, t=4, f=3, cin=2, cout=2, dtype="float32", repeats=1)
    got = profiling.conv_roofline(device="cpu", variant="block", **kw)
    want = jprofiling.conv_roofline(chip="v5e", variant="block", **kw)
    assert set(got) == set(want)
    assert got["flops_per_step"] == want["flops_per_step"] == profiling.qconv_flops(1, 4, 3, 2, 2)
    assert got["variant"] == "block" and got["chip"] == "h100"
    assert got["qconv_s"] > 0 and got["expanded_real_s"] > 0
    for variant in ("fast", "fast10"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
            profiling.conv_roofline(device="cpu", variant=variant, **kw)
    with pytest.raises(ValueError, match="cin == cout"):
        profiling.conv_roofline(device="cpu", **{**kw, "cout": 4})


def test_trace_needs_a_card_unless_forced(tmp_path):
    """Without a CUDA card, trace() warns and records nothing; force=True
    writes the host's Chrome trace."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert not profiling.trace_supported()
    with pytest.warns(UserWarning, match="no-op"):
        with profiling.trace(str(tmp_path / "none")):
            torch.ones(3) + 1
    assert not (tmp_path / "none").exists()
    with profiling.trace(str(tmp_path / "host"), force=True):
        torch.ones(3) + 1
    assert (tmp_path / "host" / "trace.json").stat().st_size > 0


def test_nan_debug_traps_forward_and_backward():
    """A forward op that makes a non-finite value raises FloatingPointError
    at that op; a backward that makes a NaN raises from anomaly mode; both
    switch off again on exit."""
    x = torch.tensor([1.0, -1.0])
    with debug.nan_debug():
        y = x * 2  # finite: passes
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(y)
        with pytest.raises(FloatingPointError):
            y / 0.0  # inf
        z = torch.zeros(2, requires_grad=True)
        loss = (torch.sqrt(z) * 0.0).sum()  # forward finite; d sqrt at 0 is 0 / 0
        # anomaly mode warns with the forward traceback, then raises
        with pytest.raises(RuntimeError, match="nan"), pytest.warns(UserWarning, match="Sqrt"):
            loss.backward()
    assert torch.isnan(torch.log(x)).any()  # off again
    assert not torch.is_anomaly_enabled()


def test_checkify_fn_surfaces_non_finite_outputs():
    def f(x):
        return torch.sqrt(x) + 1.0, x * 2

    checked = debug.checkify_fn(f)
    err, out = checked(torch.tensor([-4.0, 4.0]))
    assert "nan" in err.get()
    with pytest.raises(FloatingPointError, match="nan"):
        err.throw()
    err_ok, (a, b) = checked(torch.tensor([4.0]))
    assert err_ok.get() is None
    err_ok.throw()  # no error
    assert a.item() == pytest.approx(3.0) and b.item() == 8.0
    err_inf, _ = debug.checkify_fn(lambda x: x / 0.0)(torch.ones(2))
    with pytest.raises(FloatingPointError):
        err_inf.throw()


def test_deterministic_mode_sets_and_reports():
    """Deterministic algorithms on, cuBLAS's fixed workspace, no cuDNN
    autotuning; the returned settings say so (restored afterwards here)."""
    before = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.benchmark,
              os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    try:
        settings = debug.deterministic_mode()
        assert torch.are_deterministic_algorithms_enabled()
        assert not torch.backends.cudnn.benchmark
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == settings["CUBLAS_WORKSPACE_CONFIG"]
        assert settings["use_deterministic_algorithms"] is True
        a = torch.randn(8, 8, generator=torch.Generator().manual_seed(0))
        np.testing.assert_array_equal((a @ a).numpy(), (a @ a).numpy())
    finally:
        torch.use_deterministic_algorithms(before[0])
        torch.backends.cudnn.benchmark = before[1]
        if before[2] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = before[2]
