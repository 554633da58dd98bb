"""Is the row-contracting product ``x^T y`` as fast on this card as the same
data pre-transposed? (counterpart of ``benchmarks/probe_dgt.py``)

    python -m qasr_torch.tools.probe_dgt

Kernel J (``qasr_torch/ops/kernels/dgt.py``) at the probe's shape: M 65536
rows, K = N = 256, bf16, inputs from a seeded ``torch.Generator`` (the TPU
kernel walked M as G = 128 chunks; kernel J splits it over blocks its own
way). Three arms: ``dgt`` (x ``[M, K]``, rows contract with rows: the
orientation a weight gradient needs), ``plain`` (x pre-transposed to
``[K, M]``) and one ``torch.matmul(x.T, y)`` (the library's answer).

Prints the correctness line (each mode's largest error against
``x.float().T @ y.float()``, and the reference's scale), then one JSON line:
each arm's microseconds and TFLOP/s, the bound (the larger of the FLOPs
over the bf16 peak and the bytes over the HBM rate, from
``qasr_torch.utils.profiling.CHIPS``) and the card's name and power limit
as nvidia-smi gives them. Timing: ``steady_state_times`` over CUDA-graph
replays of n back-to-back calls, so the host's launch cost is out of the
times. Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from qasr_torch.ops.kernels.dgt import dgt
from qasr_torch.utils.profiling import CHIPS, steady_state_times

M, K, N, G = 65536, 256, 256, 128


def _graph_run(fn):
    """run(n) -> wall seconds of one replay of a CUDA graph of n calls of
    ``fn`` (captured at the first request for n, after a warm call)."""
    graphs = {}

    def run(n):
        if n not in graphs:
            fn()
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(n):
                    fn()
            graphs[n] = graph
        graphs[n].replay()  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graphs[n].replay()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    return run


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("probe_dgt needs a CUDA device; none is available")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    y = torch.randn((M, N), generator=g, device=dev).to(torch.bfloat16)
    x_t = x.T.contiguous()

    want = x.float().T @ y.float()
    errs = {mode: (dgt(xx, y, mode=mode).float() - want).abs().max().item()
            for mode, xx in (("dgt", x), ("plain", x_t))}
    print(f"dgt err: {errs['dgt']} plain err: {errs['plain']} scale {want.std().item()}",
          flush=True)

    arms = {
        "dgt": lambda: dgt(x, y, mode="dgt"),
        "plain": lambda: dgt(x_t, y, mode="plain"),
        "matmul": lambda: torch.matmul(x.T, y),
    }
    times = steady_state_times({k: _graph_run(f) for k, f in arms.items()},
                               n_small=5, n_big=30, repeats=3)
    flops = 2 * M * K * N
    nbytes = (M * K + M * N + K * N) * x.element_size()  # inputs read once, output written once
    spec = CHIPS["h100"]
    t_ops, t_bytes = flops / (spec.peak_bf16_tflops * 1e12), nbytes / (spec.hbm_gbps * 1e9)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({
        "shape": {"M": M, "K": K, "N": N}, "dtype": "bfloat16",
        **{k: {"us": v * 1e6, "tflops": flops / v / 1e12} for k, v in times.items()},
        "bound_us": max(t_ops, t_bytes) * 1e6,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "card": smi,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
