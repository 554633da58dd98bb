"""Greedy CTC decoding and the symbol tables, in plain Python.

Best path: the framewise argmax over each utterance's frames, repeats
collapsed, blanks (id 0) dropped. TIMIT ids 1..61 are the 61 training
phones in their canonical order; LibriSpeech ids 1..28 are space,
apostrophe and A..Z, and ids past the table spell nothing.
"""

from __future__ import annotations

TIMIT_61 = (
    "aa ae ah ao aw ax ax-h axr ay b bcl ch d dcl dh dx eh el em en eng epi er ey f g "
    "gcl h# hh hv ih ix iy jh k kcl l m n ng nx ow oy p pau pcl q r s sh t tcl th uh uw "
    "ux v w y z zh"
).split()
LIBRI_CHARS = [" ", "'"] + [chr(c) for c in range(ord("A"), ord("Z") + 1)]


def best_path(path) -> list[int]:
    """Collapse repeats and drop blanks of a framewise id sequence."""
    out, prev = [], None
    for i in path:
        i = int(i)
        if i != prev and i != 0:
            out.append(i)
        prev = i
    return out


def to_symbols(ids, dataset: str):
    """Ids -> a list of TIMIT phones, or a LibriSpeech string."""
    if dataset == "librispeech":
        return "".join(LIBRI_CHARS[i - 1] if 1 <= i <= len(LIBRI_CHARS) else "" for i in ids)
    return [TIMIT_61[i - 1] for i in ids if 1 <= i <= len(TIMIT_61)]
