"""Edit-distance scoring: PER with the 61->39 TIMIT protocol (the port's own
copy of ``qasr/decode/scoring.py``, through the port's native scorer).

Decode -> collapse -> map 61->39 -> edit distance -> PER. The inner loop is
the native C++ batch scorer (``qasr_torch/native/edit_distance.cpp``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from qasr_torch.data.timit import FOLD_61_TO_39, ID_TO_PHONE
from qasr_torch.native import batch_per_native

# Stable index over the folded 39-phone inventory (plus a catch-all).
FOLDED_39 = sorted({p for p in FOLD_61_TO_39.values() if p is not None})
_FOLD39_INDEX = {p: i + 1 for i, p in enumerate(FOLDED_39)}


def fold_ids_to_39_ids(ids: Sequence[int]) -> list[int]:
    """61-phone ids -> folded 39-phone ids ('q' deleted)."""
    out = []
    for i in ids:
        p = ID_TO_PHONE.get(int(i))
        if p is None:
            continue
        f = FOLD_61_TO_39.get(p, p)
        if f is not None:
            out.append(_FOLD39_INDEX[f])
    return out


def batch_per(
    refs: np.ndarray,
    ref_lens: np.ndarray,
    hyps: np.ndarray,
    hyp_lens: np.ndarray,
    *,
    fold: bool = True,
) -> tuple[int, int]:
    """Accumulate (errors, ref_tokens) over a padded batch of id sequences."""
    if fold:
        # fold each row, re-pad, then score natively
        b = len(ref_lens)
        f_refs = [fold_ids_to_39_ids(refs[i, : int(ref_lens[i])]) for i in range(b)]
        f_hyps = [fold_ids_to_39_ids(hyps[i, : int(hyp_lens[i])]) for i in range(b)]
        max_r = max((len(r) for r in f_refs), default=1) or 1
        max_h = max((len(h) for h in f_hyps), default=1) or 1
        r_arr = np.zeros((b, max_r), np.int32)
        h_arr = np.zeros((b, max_h), np.int32)
        r_lens = np.array([len(r) for r in f_refs], np.int32)
        h_lens = np.array([len(h) for h in f_hyps], np.int32)
        for i in range(b):
            r_arr[i, : r_lens[i]] = f_refs[i]
            h_arr[i, : h_lens[i]] = f_hyps[i]
        refs, ref_lens, hyps, hyp_lens = r_arr, r_lens, h_arr, h_lens
    return batch_per_native(refs, ref_lens, hyps, hyp_lens)
