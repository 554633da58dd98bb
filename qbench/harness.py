"""The benchmark's runner: one run of one cell of ``BENCHMARK.json``.

    python3 qbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell names a configuration (``qbench/configs/<config>.json``) and a
traffic mix (``qbench/traffic/<mix>.json``); the mix names its generator
(a module beside it) and its loop (``qbench/loops/<loop>.py``), which
builds the program for the configuration, drives its first steps or
requests in the set-up, runs one step or request at a time in the window,
and works out the numbers that decide ``correct``. Every metric is read by
its own file, ``qbench/metrics/<metric>.py``, whose ``read(ctx)`` returns a
number or None; ``RANGES`` and ``OPS`` in that file name the host ranges
the traced run opens around the program's calls and the operators whose
device time it reads. A loop states the length of its traced stretch,
``PROFILE_ITEMS``, itself. So a configuration, a mix, a loop, a cell or a
metric is added with files and entries only.

A run: set-up (load, weights on the device from the seed, the first steps,
every shape warmed), the window (``--seconds`` of steps or requests), with
``--trace 1`` a profiled stretch of the loop's ``PROFILE_ITEMS`` more after
it, the device's peak memory, the program's state freed, the check against
the reference, and one JSON line last on standard output.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
#: top-level module names no run may load: the JAX package and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "qasr", "bench", "benchmarks")


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_loop(bench_dir: str, name: str):
    """``loops/<name>.py``, which states its traced stretch."""
    mod = load_module(os.path.join(bench_dir, "loops", f"{name}.py"), f"qbench_loop_{name}")
    n = getattr(mod, "PROFILE_ITEMS", None)
    if isinstance(n, bool) or not isinstance(n, int) or n < 1:
        raise SystemExit(f"qbench: loops/{name}.py states no PROFILE_ITEMS (a positive whole "
                         f"number: the steps or requests of the traced run's profiled stretch)")
    return mod


def load_bench(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (``trace`` False) or per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a forbidden one, whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Context:
    """What a loop and a metric reader see of a run."""

    def __init__(self, *, conf, mix, seed, device):
        self.conf, self.mix, self.seed, self.device = conf, mix, seed, device
        self.setup_s = None
        self.window = None      # {"items": [...], "seconds": s} of the window
        self.profiled = None    # the same, of the traced run's profiled stretch
        self.trace = None       # TraceSummary of the profiled stretch
        self.shape = None       # flops.ModelShape of the configuration


def resolve(bench: dict, workload: str, root: str = ROOT, bench_dir: str = BENCH_DIR):
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"qbench: no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    conf = load_json(os.path.join(root, cfg_entry["file"]))
    mix = load_json(os.path.join(bench_dir, "traffic", f"{cell['traffic']}.json"))
    return cell, conf, mix


def run(workload: str, seed: int, seconds: float, trace: bool, *, device: str,
        t_start: float, root: str = ROOT, bench_dir: str = BENCH_DIR, shrink=None,
        bench: dict | None = None) -> dict:
    """One run on ``device``; returns the result line's object (and the
    numbers compared under ``"checks"``). ``shrink(conf, mix) -> (conf,
    mix)`` resizes the cell (the CPU tests' tiny runs)."""
    import torch

    from qbench import flops
    from qbench.checks import judge, load_limits

    bench = bench or load_bench(root)
    _, conf, mix = resolve(bench, workload, root, bench_dir)
    if shrink:
        conf, mix = shrink(conf, mix)
    ctx = Context(conf=conf, mix=mix, seed=seed, device=device)
    ctx.shape = flops.ModelShape.from_config(conf["model"], conf["data"])
    loop_mod = load_loop(bench_dir, mix["loop"])
    metrics = cell_metrics(bench, workload, trace)
    readers = {m["name"]: load_module(os.path.join(bench_dir, "metrics", f"{m['name']}.py"),
                                      f"qbench_metric_{m['name'].replace('.', '_')}")
               for m in metrics}

    drv = loop_mod.Loop(ctx)
    drv.setup()
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    ctx.setup_s = time.perf_counter() - t_start

    items, t0 = [], time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        items.append(drv.step())
    drv.sync()
    ctx.window = {"items": items, "seconds": time.perf_counter() - t0}
    if trace:
        ranges = [r for mod in readers.values() for r in getattr(mod, "RANGES", ())]
        ops = [o for mod in readers.values() for o in getattr(mod, "OPS", ())]
        ctx.profiled, ctx.trace = profile(drv, loop_mod.PROFILE_ITEMS, ranges, ops, device)

    peak = torch.cuda.max_memory_allocated() if device.startswith("cuda") else 0
    attempted, failed = drv.outcome()
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(ctx)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    drv.release()
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    numbers = drv.check()
    correct, checks = judge(numbers, load_limits(workload, bench_dir))
    result = {"correct": correct and failed == 0, "attempted": attempted, "failed": failed,
              "metrics": values, "device": device_info(device, peak)}
    if trace and ctx.trace is not None:
        result["device"]["busy_s"] = ctx.trace.busy_s
        result["device"]["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": ctx.trace.device_ops,
                               "idle_gaps": ctx.trace.idle_gaps}
    result["checks"] = {k: {"value": _num(c["value"]), "limit": c["limit"]}
                        for k, c in checks.items()}
    return result


def _num(v: float):
    """A finite number as it is; inf or nan as a string (strict JSON)."""
    return v if math.isfinite(v) else str(v)


def profile(drv, n: int, ranges, ops, device):
    """``n`` more steps or requests under ``torch.profiler``, with a host
    range around each program call that a metric names (installed for this
    stretch only)."""
    import torch

    from qbench.trace import summarize

    restore = []
    for modname, attr, name in ranges:
        mod = importlib.import_module(modname)
        orig = getattr(mod, attr, None)
        if orig is None:
            continue

        def wrapped(*a, _orig=orig, _name=name, **k):
            with torch.profiler.record_function(_name):
                return _orig(*a, **k)

        setattr(mod, attr, wrapped)
        restore.append((mod, attr, orig))
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.startswith("cuda"):
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            items = [drv.step() for _ in range(n)]
            drv.sync()
            window = time.perf_counter() - t0
    finally:
        for mod, attr, orig in restore:
            setattr(mod, attr, orig)
    return ({"items": items, "seconds": window},
            summarize(prof, window, [r[2] for r in ranges], ops))


def device_info(device: str, peak: int) -> dict:
    import torch

    if device.startswith("cuda"):
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": peak}


def cache_dirs(root: str) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths:
    the port's nvcc and g++ builds keep to ``qasr_torch/_build``; PyTorch's
    extension and Triton caches go beside them."""
    base = os.path.join(root, "qasr_torch", "_build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(base, "inductor")
    os.environ["USE_FLAX"] = "0"


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "qasr_torch")):
        print("qbench: the program (qasr_torch/) is not in this checkout", file=sys.stderr)
        return 3
    bench = load_bench(ROOT)
    cell, _, _ = resolve(bench, args.workload)
    cache_dirs(ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"qbench: {cell['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 3
    result = run(args.workload, args.seed, args.seconds, bool(args.trace), device="cuda",
                 t_start=t_start, bench=bench)
    bad = forbidden_modules()
    if bad:
        print(f"qbench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result, allow_nan=False))
    return 0
