"""The benchmark's one traffic generator: speech utterances whose durations
follow a corpus, as training batches or as transcription requests.

A mix is a JSON file beside this one (``<mix>.json``) that names this
module under ``"generator"`` and gives its parameters:

- ``"kind"``: ``"train"`` (same-bucket batches of features, labels and
  lengths for the train step) or ``"serve"`` (requests of float32
  waveforms grouped by the serving path's padding band);
- ``"durations"``: the corpus' duration distribution (``"lognormal"`` with
  ``mean_s`` and ``sigma``, or ``"beta"`` with ``a`` and ``b`` on
  ``[min_s, max_s]``), clipped to ``[min_s, max_s]``; ``"source"`` names the
  corpus and the statistics it matches, with the tolerance the tests hold
  the draw to;
- ``"buckets"``: frame ceilings (a train batch pads to its utterances'
  bucket, and frames past the largest are cut, as training batches are
  cut); for requests, the bands (the first bucket that holds an utterance,
  then doublings of the largest);
- ``"batch"``, ``"pool_utterances"``, ``"shape_seed"`` and, for training,
  ``"labels"`` (``per_s``, ids ``min_id..max_id``, ``max_len``), for serving
  ``"waveform"`` (``sample_rate``, ``noise``, ``tones``, ``amp``, ``f_min``,
  ``f_max``).

The sizes (which durations, which batches) come from ``shape_seed`` and are
the same for every run seed; the run seed shuffles the order and draws the
contents (features, labels, waveforms). So every seed does the same work.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FRAME_S = 0.01  # 10 ms frames


def subseed(seed: int, name: str) -> int:
    """A 56-bit seed for one use (``name``) of a run seed of any size."""
    return int.from_bytes(hashlib.sha256(f"{seed}:{name}".encode()).digest()[:7], "little")


def load(name: str, root: str = HERE) -> dict:
    with open(os.path.join(root, f"{name}.json")) as f:
        return json.load(f)


def durations(mix: dict) -> np.ndarray:
    """The pool's utterance durations in seconds, from ``shape_seed`` only."""
    d = mix["durations"]
    rng = np.random.default_rng(mix["shape_seed"])
    n = mix["pool_utterances"]
    if d["dist"] == "lognormal":
        mu = np.log(d["mean_s"]) - d["sigma"] ** 2 / 2
        s = rng.lognormal(mu, d["sigma"], n)
    elif d["dist"] == "beta":
        s = d["min_s"] + (d["max_s"] - d["min_s"]) * rng.beta(d["a"], d["b"], n)
    else:
        raise ValueError(f"unknown duration distribution {d['dist']!r}")
    return np.clip(s, d["min_s"], d["max_s"])


def pick_bucket(frames: int, buckets) -> int:
    """The first bucket that holds ``frames``; the largest when none does
    (the batch then cuts the utterance)."""
    for b in buckets:
        if frames <= b:
            return b
    return buckets[-1]


def serve_band(frames: int, buckets) -> int:
    """The padding band of a transcription: the first bucket that holds the
    utterance, then doublings of the largest."""
    for b in buckets:
        if frames <= b:
            return b
    p = buckets[-1]
    while p < frames:
        p *= 2
    return p


def feasible_label_len(labels: np.ndarray, frames: int) -> int:
    """The longest prefix of ``labels`` CTC can emit in ``frames`` frames:
    a prefix of L labels with r adjacent repeats needs L + r frames."""
    if labels.size == 0:
        return 0
    repeats = np.concatenate([[0], np.cumsum(labels[1:] == labels[:-1])])
    need = np.arange(1, labels.size + 1) + repeats
    return int(np.searchsorted(need, frames, side="right"))


def _groups(mix: dict, band) -> list[list[int]]:
    """Utterance indices grouped by band into full batches (a partial group
    left out), from ``shape_seed`` only."""
    frames = np.maximum(1, np.round(durations(mix) / FRAME_S).astype(int))
    pools: dict[int, list[int]] = {}
    out = []
    for i, t in enumerate(frames):
        key = band(int(t), mix["buckets"])
        pools.setdefault(key, []).append(i)
        if len(pools[key]) == mix["batch"]:
            out.append(pools.pop(key))
    return out


def train_pool(mix: dict, seed: int, n_mels: int) -> list[dict]:
    """Training batches: features N(0, 1) ``[B, T_bucket, n_mels, 4]``
    (zero past each row's frames), ``feature_lengths``, ``labels [B,
    max_len]`` of ids in ``[min_id, max_id]``, ``label_lengths`` (about
    ``per_s`` a second of audio, cut to ``max_len`` and to what CTC can emit
    in the frames kept), ``real_rows``; and ``audio_s``, the seconds of
    audio the batch trains on (its frames kept). In the run seed's order."""
    lab = mix["labels"]
    dur = durations(mix)
    shape_rng = np.random.default_rng(mix["shape_seed"] + 1)
    rate = lab["per_s"] * shape_rng.uniform(0.8, 1.2, dur.size)
    groups = _groups(mix, pick_bucket)
    rng = np.random.default_rng(subseed(seed, "traffic"))
    order = rng.permutation(len(groups))
    out = []
    for g in order:
        rows = groups[g]
        frames = [max(1, int(round(dur[i] / FRAME_S))) for i in rows]
        bucket = pick_bucket(max(frames), mix["buckets"])
        b = len(rows)
        feats = np.zeros((b, bucket, n_mels, 4), np.float32)
        labels = np.zeros((b, lab["max_len"]), np.int32)
        flens = np.zeros((b,), np.int32)
        llens = np.zeros((b,), np.int32)
        for n, (i, t) in enumerate(zip(rows, frames)):
            keep = min(t, bucket)
            feats[n, :keep] = rng.standard_normal((keep, n_mels, 4), dtype=np.float32)
            want = max(1, int(round(rate[i] * dur[i])))
            y = rng.integers(lab["min_id"], lab["max_id"] + 1, size=want).astype(np.int32)
            l = min(want, lab["max_len"])
            l = min(l, feasible_label_len(y[:l], keep))
            labels[n, :l] = y[:l]
            flens[n] = keep
            llens[n] = l
        out.append({"features": feats, "feature_lengths": flens, "labels": labels,
                    "label_lengths": llens, "real_rows": np.ones((b,), bool),
                    "audio_s": float(flens.sum()) * FRAME_S})
    return out


def serve_pool(mix: dict, seed: int, device="cpu") -> list[dict]:
    """Transcription requests: ``wavs``, a list of ``batch`` float32
    waveforms of one band (seeded noise plus ``tones`` sinusoids of random
    frequency, phase and amplitude), in shuffled order within the request;
    ``audio_s``, their seconds; ``band``. Drawn on ``device`` in bulk and
    handed over as numpy arrays, as a caller holds them."""
    import torch

    wv = mix["waveform"]
    sr = wv["sample_rate"]
    dur = durations(mix)
    groups = _groups(mix, serve_band)
    rng = np.random.default_rng(subseed(seed, "traffic"))
    gen = torch.Generator(device=device).manual_seed(subseed(seed, "waveforms"))
    out = []
    for g in rng.permutation(len(groups)):
        rows = [groups[g][i] for i in rng.permutation(len(groups[g]))]
        lens = [int(round(dur[i] * sr)) for i in rows]
        total = sum(lens)
        noise = torch.randn(total, generator=gen, device=device) * wv["noise"]
        k = wv["tones"]
        params = torch.rand((len(rows), k, 3), generator=gen, device=device)
        wavs = []
        off = 0
        for n, length in enumerate(lens):
            t = torch.arange(length, device=device, dtype=torch.float32) / sr
            f = wv["f_min"] + (wv["f_max"] - wv["f_min"]) * params[n, :, 0]
            phase = 2 * np.pi * params[n, :, 1]
            amp = wv["amp"] * (0.2 + params[n, :, 2])
            tone = (amp[:, None] * torch.sin(2 * np.pi * f[:, None] * t[None] + phase[:, None]))
            wavs.append(tone.sum(0) + noise[off:off + length])
            off += length
        host = torch.cat(wavs).cpu().numpy()
        split = np.split(host, np.cumsum(lens)[:-1])
        frames = max(1 + (length - 400) // 160 for length in lens)
        out.append({"wavs": split, "audio_s": total / sr,
                    "band": serve_band(frames, mix["buckets"])})
    return out
