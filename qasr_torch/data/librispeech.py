"""LibriSpeech character vocabulary (the port's own copy of those parts of
``qasr/data/librispeech.py``)."""

from __future__ import annotations

import numpy as np

# CTC character vocabulary: 0 = blank, 1 = space, 2 = ', 3..28 = A..Z
CHAR_VOCAB = [" ", "'"] + [chr(c) for c in range(ord("A"), ord("Z") + 1)]
CHAR_TO_ID = {c: i + 1 for i, c in enumerate(CHAR_VOCAB)}
ID_TO_CHAR = {i: c for c, i in CHAR_TO_ID.items()}
VOCAB_SIZE = len(CHAR_VOCAB) + 1  # + blank


def text_to_ids(text: str) -> np.ndarray:
    return np.array(
        [CHAR_TO_ID[c] for c in text.upper() if c in CHAR_TO_ID], np.int32
    )


def ids_to_text(ids) -> str:
    return "".join(ID_TO_CHAR.get(int(i), "") for i in ids)
