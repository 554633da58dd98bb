"""Run the JAX package's Pallas kernels on the CPU for the port's tests.

The port's tests (``tests/test_torch_*.py``) hold the PyTorch code against
the JAX package's TPU kernels run on the CPU. They run them through Pallas's
HLO interpreter (``pallas_call(..., interpret=True)``, the JAX package's own
off-TPU route for its QLSTM scan, ``qasr/ops/pallas/qlstm_scan.py:204``) and
not through the TPU interpreter of ``pltpu.force_tpu_interpret_mode()``: the
TPU interpreter runs its barriers as host callbacks that dispatch JAX
operations themselves, and such a callback racing the test's next dispatch
deadlocks the process (a test worker found stuck in the interpreter's
``update_clocks_for_device_barrier`` callback while its main thread waited
in a dispatch; tests/test_torch_fast10_model.py hung so in 2 of 4 runs
beside another test file). The HLO interpreter starts no callback.
"""

import contextlib

from jax._src import config as _config


@contextlib.contextmanager
def hlo_interpret():
    """Every ``pallas_call`` traced inside runs with ``interpret=True``, the
    way ``pltpu.force_tpu_interpret_mode()`` forces the TPU interpreter
    (through the same configuration state)."""
    state = _config.pallas_tpu_interpret_mode_context_manager
    prev = state.swap_local(True)
    try:
        yield
    finally:
        state.set_local(prev)
