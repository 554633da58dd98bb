"""Structured metric writer: console + ``metrics.jsonl`` (counterpart of
``qasr/train/metrics.py``).

Each row carries ``step``, ``time`` (the host's ``perf_counter``) and
``step_time_s`` (seconds since the previous row), beside the metrics the
loop gives it: ``loss``, ``grad_norm`` and ``audio_s_per_s_per_chip`` at
log steps, ``dev_loss`` and ``dev_per`` at eval steps, and once the state's
bytes on the device.
"""

from __future__ import annotations

import json
import os
import time

import torch


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def per_device_bytes(tree, *, cpu: bool = False) -> dict:
    """Bytes of the CUDA tensors in ``tree`` (tensors in nested dicts, lists
    and tuples: a state_dict, an optimizer's state) on each device, keyed by
    the device's name (``"cuda:0"``); ``{}`` when none lies on a CUDA
    device. ``cpu=True`` counts CPU tensors too (under ``"cpu"``)."""
    out: dict = {}
    seen = set()
    for t in _tensors(tree):
        if t.device.type != "cuda" and not (cpu and t.device.type == "cpu"):
            continue
        key = (t.data_ptr(), t.numel(), t.dtype, t.device)
        if key in seen:  # a tensor reachable twice counts once
            continue
        seen.add(key)
        out[str(t.device)] = out.get(str(t.device), 0) + t.numel() * t.element_size()
    return out


def state_bytes(state, *, cpu: bool = False) -> tuple[dict, dict]:
    """(persistent, gathered) bytes of a train state on each device (see
    :func:`per_device_bytes`): persistent is what the rank keeps between
    steps, its parameters (under tensor parallelism its shards of the
    sharded kernels) and AdamW's moments; gathered is the whole kernels a
    tensor-parallel rank gathers for its forward and backward, transient
    ({} without tensor parallelism)."""
    shards = getattr(state, "shards", None)
    opt = state.optimizer.state_dict()
    if not shards:
        return per_device_bytes((state.model.state_dict(), opt), cpu=cpu), {}
    gathered = [p for k, p in state.model.named_parameters() if shards[k] is not p]
    return (per_device_bytes((list(shards.values()), opt), cpu=cpu),
            per_device_bytes(gathered, cpu=cpu))


def device_memory_stats(device: torch.device | str = "cuda") -> dict:
    """The caching allocator's bytes in use (``torch.cuda.memory_allocated``)
    and the device's total memory (``torch.cuda.mem_get_info``), keyed by the
    device's name; ``{}`` for a CPU device or without CUDA."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return {}
    _, total = torch.cuda.mem_get_info(device)
    return {str(device): {"bytes_in_use": int(torch.cuda.memory_allocated(device)),
                          "bytes_limit": int(total)}}


class MetricWriter:
    """Writes metric rows to the console and ``<out_dir>/metrics.jsonl``
    (appended: a resumed run continues the file)."""

    def __init__(self, out_dir: str | None = None, console: bool = True):
        self.console = console
        self.jsonl = None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self.jsonl = open(os.path.join(out_dir, "metrics.jsonl"), "a")
        self._t_last = time.perf_counter()

    def write(self, step: int, metrics: dict) -> None:
        now = time.perf_counter()
        rec = {"step": step, "time": now}
        for k, v in metrics.items():
            rec[k] = float(v) if hasattr(v, "item") or isinstance(v, (int, float)) else v
        rec["step_time_s"] = now - self._t_last
        self._t_last = now
        if self.jsonl:
            self.jsonl.write(json.dumps(rec) + "\n")
            self.jsonl.flush()
        if self.console:
            shown = {k: (f"{v:.4g}" if isinstance(v, float) else v)
                     for k, v in rec.items() if k != "time"}
            print(f"[qasr] {shown}", flush=True)

    def close(self):
        if self.jsonl:
            self.jsonl.close()
            self.jsonl = None
