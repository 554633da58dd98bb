"""Write a synthetic TIMIT-format corpus (the port's own copy of
``tools/make_mini_timit.py``; at the same arguments it writes the same
bytes).

Every TIMIT phone gets a distinct deterministic formant signature
(closure/silence phones are near-silent); utterances are random phone
strings rendered at 16 kHz with per-utterance speaker coloration, and the
directory layout and speaker naming reproduce the standard splits (train,
the 50-speaker dev set, the 24-speaker core test) that
``qasr_torch.data.timit.TimitDataset`` indexes. A pipeline and convergence
fixture, not a phonetics simulation: PER on it measures that the model
learns, not how well it would do on real speech.

Usage:
    python -m qasr_torch.tools.make_mini_timit --out /tmp/qasr_mini_timit \\
        --train-speakers 12 --utts-per-speaker 8 --seed 0
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from qasr_torch.data.timit import CORE_TEST_SPEAKERS, DEV_SPEAKERS, TIMIT_61, write_riff

RATE = 16000
# Closure/silence-like phones render as near-silence, like real TIMIT.
SILENT = {"h#", "pau", "epi", "pcl", "tcl", "kcl", "bcl", "dcl", "gcl", "q"}


def phone_bank(seed: int) -> dict[str, dict]:
    """Deterministic per-phone acoustic signature: 3 formants + noise mix."""
    rng = np.random.RandomState(seed)
    bank = {}
    for p in TIMIT_61:
        f1 = rng.uniform(250, 900)
        f2 = rng.uniform(900, 2600)
        f3 = rng.uniform(2600, 6800)
        bank[p] = {
            "formants": np.array([f1, f2, f3]),
            "amps": rng.uniform(0.3, 1.0, size=3),
            "noise": rng.uniform(0.02, 0.5),  # fricative-ness
            "dur_ms": rng.uniform(45, 110),   # mean duration
        }
    return bank


def render_utterance(
    phones: list[str],
    bank: dict,
    rng: np.random.RandomState,
    speaker_shift: float,
    silent: frozenset | set = frozenset(SILENT),
) -> tuple[np.ndarray, list[tuple[int, int, str]]]:
    """Render a symbol string to 16 kHz samples + (start, end, symbol) rows."""
    segs, marks, pos = [], [], 0
    for p in phones:
        spec = bank[p]
        dur = int(RATE * spec["dur_ms"] * rng.uniform(0.7, 1.4) / 1000.0)
        dur = max(dur, int(0.025 * RATE))  # at least one analysis window
        t = np.arange(dur) / RATE
        if p in silent:
            sig = 0.01 * rng.randn(dur)
        else:
            sig = np.zeros(dur)
            for f, a in zip(spec["formants"], spec["amps"]):
                # mild per-speaker vocal-tract scaling + random phase
                sig += a * np.sin(
                    2 * np.pi * f * speaker_shift * t + rng.uniform(0, 2 * np.pi)
                )
            sig = (1 - spec["noise"]) * sig + spec["noise"] * rng.randn(dur)
            # attack/decay envelope so boundaries aren't clicks
            env = np.minimum(1.0, np.minimum(np.arange(dur), np.arange(dur)[::-1]) / 80.0)
            sig *= env * 0.25
        segs.append(sig)
        marks.append((pos, pos + dur, p))
        pos += dur
    wav = np.concatenate(segs)
    return np.clip(wav * 32767 * 0.8, -32767, 32767).astype(np.int16), marks


def write_utt(d: str, name: str, phones, bank, rng, shift) -> None:
    os.makedirs(d, exist_ok=True)
    wav, marks = render_utterance(phones, bank, rng, shift)
    write_riff(os.path.join(d, f"{name}.wav"), wav)
    with open(os.path.join(d, f"{name}.phn"), "w") as f:
        for s, e, p in marks:
            f.write(f"{s} {e} {p}\n")


def random_sentence(rng: np.random.RandomState, pool: list[str]) -> list[str]:
    n = rng.randint(6, 15)
    body = [pool[rng.randint(len(pool))] for _ in range(n)]
    return ["h#"] + body + ["h#"]


def write_corpus(out: str, *, train_speakers: int = 12, utts_per_speaker: int = 8,
                 dev_speakers: int = 8, test_speakers: int = 8, seed: int = 0) -> dict:
    """Write the corpus under ``out``; returns the utterance count of each
    split (``train``, ``dev``, ``core_test``)."""
    bank = phone_bank(seed)
    rng = np.random.RandomState(seed + 1)
    pool = [p for p in TIMIT_61 if p not in SILENT]

    def speaker_utts(split_dir: str, speaker: str, n: int) -> None:
        shift = rng.uniform(0.9, 1.1)
        d = os.path.join(out, split_dir, f"dr{1 + rng.randint(8)}", speaker)
        for u in range(n):
            write_utt(d, f"si{u * 4 + 1}", random_sentence(rng, pool), bank, rng, shift)

    for s in range(train_speakers):
        sex = "mf"[s % 2]
        speaker_utts("train", f"{sex}trn{s}", utts_per_speaker)
    for speaker in sorted(DEV_SPEAKERS)[:dev_speakers]:
        speaker_utts("test", speaker, utts_per_speaker)
    for speaker in sorted(CORE_TEST_SPEAKERS)[:test_speakers]:
        speaker_utts("test", speaker, utts_per_speaker)
    return {"train": train_speakers * utts_per_speaker,
            "dev": min(dev_speakers, len(DEV_SPEAKERS)) * utts_per_speaker,
            "core_test": min(test_speakers, len(CORE_TEST_SPEAKERS)) * utts_per_speaker}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True)
    ap.add_argument("--train-speakers", type=int, default=12)
    ap.add_argument("--utts-per-speaker", type=int, default=8)
    ap.add_argument("--dev-speakers", type=int, default=8)
    ap.add_argument("--test-speakers", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    n = write_corpus(args.out, train_speakers=args.train_speakers,
                     utts_per_speaker=args.utts_per_speaker, dev_speakers=args.dev_speakers,
                     test_speakers=args.test_speakers, seed=args.seed)
    print(f"wrote {args.out}: {n['train']} train utts, {n['dev']} dev, "
          f"{n['core_test']} core-test")


if __name__ == "__main__":
    main()
