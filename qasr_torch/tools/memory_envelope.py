"""Config 5's (``librispeech_large``) per-card memory envelope, measured on
the card (the port's counterpart of ``tools/memory_envelope.py``): the first
real LibriSpeech run must not be the first time anyone learns whether a
batch and bucket fit.

For each (batch, bucket T) point, with and without ``train.remat_convs``,
the tool builds the preset on the card, runs one warm-up train step (forward,
CTC, backward, clipped AdamW: the moments exist after it), resets the
allocator's peak and runs one more step, and reports:

- ``args_gb``: the parameters, AdamW's two moments and the batch, counted
  from the tensors (the reference's compiled arguments);
- ``temp_gb``: ``torch.cuda.max_memory_allocated`` over that step, less
  what the process held before the point and less ``args_gb``
  (activations, gradients, workspaces);
- ``total_gb``, ``b``, ``t``, ``remat``, ``fits`` (``total_gb`` under 95% of
  ``--hbm-gb``, the card's memory by default) and ``step_ms`` (the timed
  step's wall time, synchronised).

A point that runs out of memory (``torch.cuda.OutOfMemoryError``) becomes an
``error`` row, and the allocator's cache is emptied before the next, as the
reference turns a compile-time OOM into a row; any other failure raises.
There is no host mode: the peak is the card's.

  python -m qasr_torch.tools.memory_envelope [--preset librispeech_large]
      [--points 4:2048,8:2048,...] [--hbm-gb 80] [--as-json]
"""

from __future__ import annotations

import argparse
import gc
import json
import time

import torch

# the reference's default points (tools/memory_envelope.py)
POINTS = "4:2048,8:2048,16:2048,16:1024,32:1024,64:512,64:2048"
GB = 1e9


def point_batch(cfg, b: int, t: int) -> dict:
    """The point's random batch (``qasr_torch.data.synthetic.random_batch``):
    ``b`` utterances of ``t`` frames, labels padded to the preset's
    ``max_label_len`` with ``t // 8`` of them real (a CTC-feasible length)."""
    from qasr_torch.data.synthetic import random_batch

    label_len = min(t // 8, cfg.data.max_label_len)
    return random_batch(b, t, cfg.data.n_mels, cfg.model.vocab, label_len,
                        pad_to=cfg.data.max_label_len)


def argument_bytes(state, batch: dict) -> int:
    """The bytes of the step's arguments: every parameter, AdamW's two
    moments of it (its step counts, a scalar a parameter, are left out) and
    every tensor of ``batch``."""
    params = list(state.model.parameters())
    moments = [v for p in params for v in state.optimizer.state.get(p, {}).values()
               if torch.is_tensor(v) and v.shape == p.shape]
    return sum(t.numel() * t.element_size() for t in (*params, *moments, *batch.values()))


def measure_point(cfg, b: int, t: int, remat: bool, *, device="cuda") -> dict:
    """One point on ``device`` (a CUDA card): ``args_gb``, ``temp_gb``,
    ``total_gb`` and ``step_ms``. Raises ``ValueError`` off the card."""
    from qasr_torch.train.state import create_train_state
    from qasr_torch.train.step import batch_to_device, train_step

    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the memory envelope reads a CUDA card's peak "
                         f"(torch.cuda.max_memory_allocated); got device {dev}")
    cfg = cfg.override(**{"data.batch_size": b, "data.bucket_sizes": (t,),
                          "train.remat_convs": remat})
    held = torch.cuda.memory_allocated(dev)  # the caller's tensors, not the point's
    state = create_train_state(cfg, device=dev)
    batch = batch_to_device(point_batch(cfg, b, t), dev)
    train_step(state, batch)  # warm-up: AdamW's moments, cuDNN's plans
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    train_step(state, batch)
    torch.cuda.synchronize(dev)
    step_ms = (time.perf_counter() - t0) * 1e3
    args = argument_bytes(state, batch)
    peak = torch.cuda.max_memory_allocated(dev) - held
    return {"args_gb": args / GB, "temp_gb": (peak - args) / GB, "total_gb": peak / GB,
            "step_ms": step_ms}


def envelope(cfg, points, *, hbm_gb: float, device="cuda", echo=None) -> list[dict]:
    """The rows of every ``(b, t)`` in ``points``, without and with remat;
    ``echo(row)`` is called as each row is made."""
    rows = []
    for b, t in points:
        for remat in (False, True):
            try:
                r = measure_point(cfg, b, t, remat, device=device)
                r.update(b=b, t=t, remat=remat, fits=r["total_gb"] < hbm_gb * 0.95)
            except torch.cuda.OutOfMemoryError as e:
                r = {"b": b, "t": t, "remat": remat, "error": str(e)[:120]}
            gc.collect()
            torch.cuda.empty_cache()
            rows.append(r)
            if echo is not None:
                echo(r)
    return rows


def format_row(r: dict, hbm_gb: float) -> str:
    """The reference's printed line for a row."""
    head = f"B{r['b']} T{r['t']} remat={int(r['remat'])}"
    if "error" in r:
        return f"{head}: ERROR {r['error']}"
    return (f"{head}: args {r['args_gb']:.2f} GB + temps {r['temp_gb']:.2f} GB"
            f" = {r['total_gb']:.2f} GB {'FITS' if r['fits'] else 'OOM'}"
            f" (of {hbm_gb:.0f} GB)")


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default="librispeech_large")
    ap.add_argument("--points", default=POINTS,
                    help="comma list of per-card batch:bucketT points")
    ap.add_argument("--hbm-gb", type=float, default=None,
                    help="the card's memory in GB (default: the card's total_memory)")
    ap.add_argument("--as-json", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from qasr_torch.configs import get_config

    dev = torch.device(args.device)
    if dev.type != "cuda":
        raise ValueError(f"the memory envelope needs a CUDA card; got device {dev}")
    hbm_gb = args.hbm_gb or torch.cuda.get_device_properties(dev).total_memory / GB
    points = [tuple(int(v) for v in p.split(":")) for p in args.points.split(",")]
    echo = None if args.as_json else (lambda r: print(format_row(r, hbm_gb), flush=True))
    rows = envelope(get_config(args.preset), points, hbm_gb=hbm_gb, device=dev, echo=echo)
    if args.as_json:
        print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
