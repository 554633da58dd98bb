"""Where does the QLSTM input projection's block product stop beating kernel
B? (``qasr_torch.models.qlstm.BLOCK_ROWS``)

    python -m qasr_torch.tools.sweep_input_proj

Times config 4's input projection (``librispeech_qlstm``: N = 2 directions
x 4H = 2048 quaternion outputs) on both arms of
``qasr_torch.models.qlstm.input_proj_fn``: ``fast8`` (kernel B forward, its
dx role and the dW) and ``block`` (one matmul on the Hamilton-expanded
weight and its autograd), forward alone and forward plus backward, at M =
B*T rows 2048 to 16384 and K = the tower's F*C (layer 0: 13 x 128) and 2H
(layers 1-2), bf16 compute on f32 weights, inputs from a seeded
``torch.Generator``. Prints one line, "crossover on <card>: ...", with each
arm's ms (CUDA events, the mean of 5 calls after two warm ones) and the
card's name and power limit as nvidia-smi gives them. Gates nothing. Needs a
CUDA card.
"""

from __future__ import annotations

import subprocess
import sys

import torch

from qasr_torch.configs import get_config
from qasr_torch.models.qlstm import input_proj_fn

ROWS = (2048, 4096, 8192, 16384)


def _time_ms(fn, n: int = 5, warm: int = 2) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def sweep(dev: torch.device, rows=ROWS) -> list[dict]:
    """One dict a (K, M): each arm's forward and forward + backward ms."""
    cfg = get_config("librispeech_qlstm")
    H, conv = cfg.model.lstm_features, cfg.model.conv_features
    nf = (cfg.data.n_mels - cfg.model.pool_size) // cfg.model.pool_size + 1
    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    out = []
    for k in (nf * conv[-1], 2 * H):
        for m in rows:
            xp = (torch.randn(m, 4 * k, generator=g, device=dev) * 0.5).to(bf16).requires_grad_()
            wp = (torch.randn(4, k, 8 * H, generator=g, device=dev) * k ** -0.5).requires_grad_()
            dyp = torch.randn(m, 4 * 8 * H, generator=g, device=dev).to(bf16)
            row = {"K": k, "M": m}
            for name in ("fast8", "block"):
                fn = input_proj_fn(name, m)
                with torch.no_grad():
                    row[f"{name}_fwd"] = _time_ms(lambda: fn(xp, wp.to(bf16)))

                def fwd_bwd():
                    xp.grad = None
                    wp.grad = None
                    fn(xp, wp.to(bf16)).backward(dyp)

                row[f"{name}_fwd_bwd"] = _time_ms(fwd_bwd)
            out.append(row)
            del xp, wp, dyp
    torch.cuda.empty_cache()
    return out


def line(rows: list[dict], smi: str, n_out: int) -> str:
    return (f"crossover on {smi} (input projection, N{n_out} bf16, ms; kernel B = fast8, "
            "block = the expanded matmul): " + "; ".join(
                f"K{r['K']} M{r['M']}: fwd kernel B {r['fast8_fwd']:.3f} block "
                f"{r['block_fwd']:.3f}, fwd+bwd kernel B {r['fast8_fwd_bwd']:.3f} block "
                f"{r['block_fwd_bwd']:.3f}" for r in rows))


def main(argv=None) -> int:
    del argv
    if not torch.cuda.is_available():
        print("sweep_input_proj needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    n_out = 8 * get_config("librispeech_qlstm").model.lstm_features
    print(line(sweep(dev), smi, n_out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
