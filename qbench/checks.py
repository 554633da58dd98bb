"""The numbers that decide ``correct``: what the timed path produced against
the plain reference, each held to its limit from ``limits/<cell>.json``.

Training (the first three steps the set-up drives through the window's own
call and feed):

- ``loss_gap``: the largest ``|loss - ref| / |ref|`` over the steps;
- ``grad_norm_gap``: the worst leaf's ``| |g| - |g_ref| |`` of the first
  step's clipped gradient (the program's as its optimizer took it, read
  back from AdamW's first moment after one step), over the larger of that
  leaf's reference norm and the median leaf's;
- ``update_gap``: the same for each parameter's change over the three
  steps, leaving out the leaves whose reference gradient is below a
  thousandth of the median leaf's (they move by round-off alone);
- ``logit_gap``: the first step's train-mode logits, the largest
  ``|logit - ref|`` over the utterances' frames, over the largest ``|ref|``
  (the norm gaps above average a precision's rounding away; this does not).

Serving (a seeded sample of the window's requests, the longest among them,
read by hooks on the served model's call):

- ``feature_gap``: the largest absolute difference of the front end's
  normalised features over the utterances' frames;
- ``token_gap``: the widest gap, in nats, by which the reference's logit of
  a served (framewise greedy) token lies below the reference's best;
- ``logit_gap``: the largest ``|logit - ref|`` over the frames, over the
  largest ``|ref|``;
- ``text_mismatch``: the utterances whose returned transcript is not the
  greedy decode of the served logits (exact: limit 0).
"""

from __future__ import annotations

import json
import math
import os
import statistics

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
#: a leaf whose reference gradient norm is below this share of the median
#: leaf's is left out of the change (it moves by round-off alone)
GRAD_FLOOR = 1e-3


def _leaf_gap(prog: dict, ref: dict, keys) -> float:
    keys = list(keys)
    if not keys:
        return 0.0
    median = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30) for k in keys)


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref`` hold ``losses`` (floats), ``grad_norms`` and
    ``change_norms`` (name -> float), the first step's ``logits [B, T, V]``
    and its ``lengths``."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]) or not all(map(math.isfinite, prog["losses"])):
        loss_gap = math.inf
    g = ref["grad_norms"]
    median_g = statistics.median(g.values())
    moving = [k for k in g if g[k] >= GRAD_FLOOR * median_g]
    return {
        "loss_gap": loss_gap,
        "grad_norm_gap": _leaf_gap(prog["grad_norms"], g, g.keys()),
        "update_gap": _leaf_gap(prog["change_norms"], ref["change_norms"], moving),
        "logit_gap": max(_logit_gap(p[:n], r[:n]) for p, r, n in
                         zip(prog["logits"], ref["logits"], [int(n) for n in ref["lengths"]])),
    }


def _logit_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.float()
    return float((got.float().to(ref.device) - ref).abs().max() / ref.abs().max())


def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


def serve_numbers(samples: list[dict]) -> dict:
    """Each sample: ``feats``/``ref_feats`` (``[T, n_mels, 4]`` of one
    utterance's frames), ``logits``/``ref_logits`` (``[T, V]``), ``text``
    (the program's) and ``ref_text`` (the greedy decode of ``logits``)."""
    fg = tg = lg = 0.0
    mismatch = 0
    for s in samples:
        fg = max(fg, float((s["feats"] - s["ref_feats"]).abs().max()))
        ref = s["ref_logits"].float()
        served = s["logits"].float().argmax(dim=-1)
        gap = ref.max(dim=-1).values - ref.gather(1, served[:, None])[:, 0]
        tg = max(tg, float(gap.max()))
        lg = max(lg, _logit_gap(s["logits"], ref))
        mismatch += int(s["text"] != s["ref_text"])
    return {"feature_gap": fg, "token_gap": tg, "logit_gap": lg,
            "text_mismatch": float(mismatch)}


def load_limits(cell: str, root: str = HERE) -> dict:
    path = os.path.join(root, "limits", f"{cell}.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and each number beside its limit. A number without a
    limit, or not finite, fails."""
    out, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name, {}).get("limit")
        out[name] = {"value": value, "limit": limit}
        if limit is None or not (math.isfinite(value) and value <= limit):
            ok = False
    return ok and bool(numbers), out
