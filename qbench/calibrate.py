"""Readings that set the limits of ``correct`` (not run by the benchmark):

    python3 qbench/calibrate.py --workload <cell> --seeds 1,2,3 --mode sound|control|<fault>

``sound``: the program as the cell runs it, against the reference, on each
seed (the lower readings). ``control``: the reference computed a precision
below the configuration's (bf16 -> fp8 operands; the front end's f32 ->
TF32) in the program's place (upper readings). A fault of ``faults.py``:
the program with that fault planted. One JSON line a seed, on the cell's
own sizes; training needs no window, serving runs each request of the
mix's pool once (the sample the check compares is among them).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from qbench import checks, harness  # noqa: E402
from qbench.faults import planted  # noqa: E402


def readings(workload: str, seed: int, mode: str, device: str = "cuda", shrink=None,
             bench: dict | None = None) -> dict:
    import torch

    bench = bench or harness.load_bench()
    _, conf, mix = harness.resolve(bench, workload)
    if shrink:
        conf, mix = shrink(conf, mix)
    ctx = harness.Context(conf=conf, mix=mix, seed=seed, device=device)
    drv = harness.load_loop(harness.BENCH_DIR, mix["loop"]).Loop(ctx)
    kind = mix["loop"]
    if mode == "control":
        drv.prepare()
        if kind == "train":
            low = drv.reference("fp8")
            low.pop("params")
            ref = drv.reference("f32")
            ref.pop("params")
            return checks.train_numbers(low, ref)
        return checks.serve_numbers(drv.samples("tf32", "fp8", program=False))
    with (contextlib.nullcontext() if mode == "sound" else planted(kind, mode)):
        drv.setup()
        if kind == "serve":
            for _ in range(len(drv.pool)):
                drv.step()
        drv.sync()
    drv.release()
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    return drv.check()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", default="sound")
    args = p.parse_args(argv)
    harness.cache_dirs(harness.ROOT)
    import torch

    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        nums = readings(args.workload, int(s), args.mode)
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": int(s),
                          "numbers": nums, "seconds": time.perf_counter() - t0,
                          "peak_bytes": torch.cuda.max_memory_allocated()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
