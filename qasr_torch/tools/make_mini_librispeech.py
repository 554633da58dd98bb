"""Write a synthetic LibriSpeech-format corpus (the port's own copy of
``tools/make_mini_librispeech.py``; at the same arguments it writes the same
bytes).

The standard LibriSpeech layout (``<split>/<spk>/<ch>/<spk>-<ch>-<utt>.wav``
+ ``<spk>-<ch>.trans.txt``), each character rendered with a distinct
deterministic formant signature (space = silence), so that
``qasr_torch.data.librispeech.LibriSpeechDataset`` and
``LibriFeaturePipeline`` index and learn it. Audio is written as RIFF wav
(the FLAC path needs an encoder, which the repo does not have).

Usage:
    python -m qasr_torch.tools.make_mini_librispeech --out /tmp/qasr_mini_libri \\
        --speakers 8 --utts-per-speaker 12 --seed 0
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from qasr_torch.data.librispeech import CHAR_VOCAB
from qasr_torch.data.timit import write_riff
from qasr_torch.tools.make_mini_timit import render_utterance

# Small fixed word list keeps label entropy realistic (letters recur across
# words) while staying fully covered by the vocab.
WORDS = [
    "THE", "CAT", "DOG", "RAN", "FAST", "OVER", "BLUE", "HILL", "SONG",
    "JUMP", "QUIZ", "WAVE", "FOX", "YARN", "KING", "PLOD", "MYTH", "EXAM",
]


def char_bank(seed: int) -> dict[str, dict]:
    rng = np.random.RandomState(seed)
    bank = {}
    for c in CHAR_VOCAB:
        bank[c] = {
            "formants": np.array(
                [rng.uniform(250, 900), rng.uniform(900, 2600), rng.uniform(2600, 6800)]
            ),
            "amps": rng.uniform(0.3, 1.0, size=3),
            "noise": rng.uniform(0.02, 0.5),
            "dur_ms": rng.uniform(45, 110),
        }
    return bank


def random_text(rng: np.random.RandomState) -> str:
    n = rng.randint(2, 6)
    return " ".join(WORDS[rng.randint(len(WORDS))] for _ in range(n))


def write_corpus(out: str, *, speakers: int = 8, utts_per_speaker: int = 12,
                 dev_speakers: int = 4, seed: int = 0) -> dict:
    """Write ``train-clean-100`` and ``dev-clean`` under ``out``; returns
    their utterance counts (``train``, ``dev``)."""
    bank = char_bank(seed)
    rng = np.random.RandomState(seed + 1)
    silent = {" "}

    def write_split(split: str, spk0: int, n_speakers: int) -> int:
        n = 0
        for s in range(n_speakers):
            spk, ch = spk0 + s, 1
            d = os.path.join(out, split, str(spk), str(ch))
            os.makedirs(d, exist_ok=True)
            shift = rng.uniform(0.9, 1.1)
            lines = []
            for u in range(utts_per_speaker):
                text = random_text(rng)
                utt_id = f"{spk}-{ch}-{u:04d}"
                wav, _ = render_utterance(list(text), bank, rng, shift, silent)
                write_riff(os.path.join(d, utt_id + ".wav"), wav)
                lines.append(f"{utt_id} {text}")
                n += 1
            with open(os.path.join(d, f"{spk}-{ch}.trans.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
        return n

    n_train = write_split("train-clean-100", 100, speakers)
    n_dev = write_split("dev-clean", 900, dev_speakers)
    return {"train": n_train, "dev": n_dev}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True)
    ap.add_argument("--speakers", type=int, default=8)
    ap.add_argument("--utts-per-speaker", type=int, default=12)
    ap.add_argument("--dev-speakers", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    n = write_corpus(args.out, speakers=args.speakers, utts_per_speaker=args.utts_per_speaker,
                     dev_speakers=args.dev_speakers, seed=args.seed)
    print(f"wrote {args.out}: {n['train']} train utts, {n['dev']} dev")


if __name__ == "__main__":
    main()
