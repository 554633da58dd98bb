"""Scaling-efficiency table: audio-s/s per card at 1 card, 1 host and N
hosts (the port's counterpart of ``tools/run_scaling_table.py``; the north
star asks for >= 80% efficiency 1 card -> 1 host -> N >= 2 hosts).

DP weak scaling: the per-card batch is held fixed while the mesh grows, so
perfect scaling is a flat audio-s/s per card. Run it under
``torch.distributed.run``, one process a card (NCCL; ``--device cpu``
gloo), or as a plain process (a world of one):

  python -m torch.distributed.run --nproc-per-node 1 -m qasr_torch.tools.run_scaling_table \\
      [--preset timit_qcnn] [--b-per-chip 16] [--t 256] [--n-small 4] [--n-big 24]

The 1-card row is measured only in a world of one, as the reference's
(a one-device mesh is not every rank's to run); in a larger world the
table has the world's row, its efficiency null, as the reference's
multi-host table has it. A step's time is ``(t_big - t_small) / (n_big -
n_small)`` over runs of ``n_small`` and ``n_big`` steps, each closed by
reading the loss back. Only rank 0 prints the JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

FRAME_S = 0.010  # 10 ms hop


def measure(cfg, mesh, b_per_chip: int, t: int, n_small: int, n_big: int, device) -> float:
    """Seconds of one DP train step on ``mesh`` at ``b_per_chip`` rows a
    rank (the port's random batch), by the difference of two runs."""
    from qasr_torch.data.synthetic import random_batch
    from qasr_torch.parallel import create_sharded_train_state, make_sharded_train_step

    n = mesh.size
    cfg = cfg.override(**{"data.batch_size": b_per_chip * n})
    batch = random_batch(b_per_chip * n, t, cfg.data.n_mels, cfg.model.vocab, 48)
    state, _ = create_sharded_train_state(cfg, mesh, device=device)
    step = make_sharded_train_step(cfg, mesh)

    def run(k: int) -> float:
        t0 = time.perf_counter()
        for _ in range(k):
            m = step(state, batch)
        loss = float(m["loss"])  # reading it back syncs the device
        if not np.isfinite(loss):
            raise FloatingPointError(f"loss {loss}")
        return time.perf_counter() - t0

    run(1)  # warm-up: builds, plans, AdamW's moments
    ts = run(n_small)
    tb = run(n_big)
    return (tb - ts) / (n_big - n_small)


def _row(chips: int, hosts: int, dt: float, audio_per_chip: float, base: float | None) -> dict:
    v = audio_per_chip / dt
    return {"chips": chips, "hosts": hosts, "step_ms": round(dt * 1e3, 2),
            "audio_s_per_s_per_chip": round(v, 1),
            "efficiency": round(v / base, 3) if base else None}


def main(argv=None) -> dict | None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default="timit_qcnn")
    ap.add_argument("--b-per-chip", type=int, default=16)
    ap.add_argument("--t", type=int, default=256)
    ap.add_argument("--n-small", type=int, default=4)
    ap.add_argument("--n-big", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, a rank a card) or cpu (gloo)")
    args = ap.parse_args(argv)

    from qasr_torch.cli import _join_world
    from qasr_torch.configs import get_config
    from qasr_torch.parallel import make_mesh
    from qasr_torch.parallel.mesh import world

    cfg = get_config(args.preset)
    device, rank = _join_world(args.device)
    try:
        _, size = world()
        local = int(os.environ.get("LOCAL_WORLD_SIZE", size))
        audio_per_chip = args.b_per_chip * args.t * FRAME_S
        measure_args = (args.b_per_chip, args.t, args.n_small, args.n_big, device)
        if size == 1:
            dt1 = measure(cfg, make_mesh(1, 1), *measure_args)
            rows = [_row(1, 1, dt1, audio_per_chip, audio_per_chip / dt1)]
        else:
            dtn = measure(cfg, make_mesh(size, 1), *measure_args)
            rows = [_row(size, size // local, dtn, audio_per_chip, None)]
        line = {
            "protocol": "dp_weak_scaling",
            "preset": args.preset,
            "b_per_chip": args.b_per_chip,
            "t_frames": args.t,
            "backend": torch.device(device).type,
            "rows": rows,
            "north_star": ">= 0.80 efficiency at every row",
        }
        if rank == 0:
            print(json.dumps(line), flush=True)
        return line
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
