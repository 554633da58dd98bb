"""LibriSpeech corpus reader: the character vocabulary, transcripts and
``LibriSpeechDataset`` (the port's own copy of ``qasr/data/librispeech.py``).

Layout: ``<root>/<split>/<speaker>/<chapter>/<spk>-<ch>-<utt>.{flac,wav}``
with ``<spk>-<ch>.trans.txt`` transcript files. FLAC decodes through the
port's native decoder (``qasr_torch.native.flac_decode_native``), RIFF wav
through ``qasr_torch.data.timit.read_sphere``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from qasr_torch.data.timit import read_sphere

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


@dataclass
class LibriUtterance:
    audio_path: str
    text: str


class LibriSpeechDataset:
    """The utterances of one LibriSpeech split directory, sorted by path."""

    def __init__(self, root: str, split: str = "train-clean-100"):
        base = os.path.join(root, split) if split else root
        if not os.path.isdir(base):
            raise FileNotFoundError(
                f"LibriSpeech split {base!r} not found — this container has no "
                "LibriSpeech audio; use dataset='synthetic' (see SURVEY.md §7)."
            )
        self.utterances: list[LibriUtterance] = []
        for dirpath, _, files in os.walk(base):
            for fn in sorted(files):
                if not fn.endswith(".trans.txt"):
                    continue
                with open(os.path.join(dirpath, fn)) as f:
                    for line in f:
                        utt_id, _, text = line.strip().partition(" ")
                        if not text:
                            continue
                        for ext in (".wav", ".flac"):
                            cand = os.path.join(dirpath, utt_id + ext)
                            if os.path.exists(cand):
                                self.utterances.append(LibriUtterance(cand, text))
                                break
        if not self.utterances:
            raise FileNotFoundError(f"no LibriSpeech utterances under {base!r}")
        self.utterances.sort(key=lambda u: u.audio_path)

    def __len__(self):
        return len(self.utterances)

    def load(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """-> (float32 waveform in [-1, 1], int32 character ids)."""
        utt = self.utterances[i]
        if utt.audio_path.endswith(".flac"):
            from qasr_torch.native import flac_decode_native

            samples, _ = flac_decode_native(utt.audio_path)
            samples = samples[:, 0]  # LibriSpeech is mono
        else:
            samples, _ = read_sphere(utt.audio_path)
        return samples.astype(np.float32) / 32768.0, text_to_ids(utt.text)
