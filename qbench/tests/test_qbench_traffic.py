"""The traffic generator: deterministic per seed, different across seeds,
the same sizes for every seed, durations matched to each corpus within the
tolerance its mix file states, CTC-feasible labels, and cuts as training
batches cut."""

from __future__ import annotations

import glob
import os

import numpy as np
import pytest

from qbench.traffic import utterances

MIXES = sorted(os.path.basename(p)[:-5]
               for p in glob.glob(os.path.join(utterances.HERE, "*.json")))
TRAIN = [m for m in MIXES if utterances.load(m)["kind"] == "train"]
SERVE = [m for m in MIXES if utterances.load(m)["kind"] == "serve"]
BIG = 2**31 + 987654321


@pytest.mark.parametrize("name", MIXES)
def test_durations_match_the_corpus(name):
    mix = utterances.load(name)
    d = utterances.durations(mix)
    src = mix["source"]
    assert abs(d.mean() - src["mean_s"]) <= src["mean_tolerance"] * src["mean_s"]
    assert d.min() >= src["min_s"] - 1e-9 and d.max() <= src["max_s"] + 1e-9


@pytest.mark.parametrize("name", TRAIN)
def test_train_batches(name):
    from qasr_torch.data.batching import make_batch

    mix = utterances.load(name)
    a = utterances.train_pool(mix, BIG, 40)
    b = utterances.train_pool(mix, BIG, 40)
    c = utterances.train_pool(mix, BIG + 1, 40)
    assert all(np.array_equal(x["features"], y["features"]) for x, y in zip(a, b))
    assert any(not np.array_equal(x["features"], y["features"]) for x, y in zip(a, c))
    # the same sizes for every seed, in another order
    assert sorted(x["audio_s"] for x in a) == pytest.approx(sorted(x["audio_s"] for x in c))
    assert [x["audio_s"] for x in a] != [x["audio_s"] for x in c]
    lab = mix["labels"]
    for x in a:
        t = x["features"].shape[1]
        assert t in mix["buckets"]
        assert len(x["feature_lengths"]) == mix["batch"]
        assert (x["feature_lengths"] <= t).all()
        assert (x["label_lengths"] <= lab["max_len"]).all() and (x["label_lengths"] > 0).all()
        for row, n, frames in zip(x["labels"], x["label_lengths"], x["feature_lengths"]):
            y = row[:n]
            assert ((y >= lab["min_id"]) & (y <= lab["max_id"])).all() and not row[n:].any()
            assert n + int((y[1:] == y[:-1]).sum()) <= frames
    # the largest bucket cuts as make_batch does
    top = [x for x in a if x["features"].shape[1] == mix["buckets"][-1]][0]
    ex = [(row[:n], lab_row[:m]) for row, n, lab_row, m in
          zip(top["features"], top["feature_lengths"], top["labels"], top["label_lengths"])]
    mb = make_batch(ex, mix["buckets"][-1], lab["max_len"])
    np.testing.assert_array_equal(mb["features"], top["features"])
    np.testing.assert_array_equal(mb["feature_lengths"], top["feature_lengths"])
    np.testing.assert_array_equal(mb["labels"], top["labels"])


def test_cut_at_the_largest_bucket():
    mix = utterances.load("libri_train_b32")
    longest = max(utterances.durations(mix))
    assert longest * 100 > mix["buckets"][-1]
    pool = utterances.train_pool(mix, 3, 40)
    assert max(int(x["feature_lengths"].max()) for x in pool) == mix["buckets"][-1]


@pytest.mark.parametrize("name", SERVE)
def test_serve_requests(name):
    mix = dict(utterances.load(name), pool_utterances=96)
    a = utterances.serve_pool(mix, BIG)
    b = utterances.serve_pool(mix, BIG)
    c = utterances.serve_pool(mix, BIG + 1)
    assert all(np.array_equal(u, v) for x, y in zip(a, b) for u, v in zip(x["wavs"], y["wavs"]))
    assert sorted(x["audio_s"] for x in a) == pytest.approx(sorted(x["audio_s"] for x in c))
    assert any(not np.array_equal(x["wavs"][0], y["wavs"][0]) for x, y in zip(a, c))
    for x in a:
        assert len(x["wavs"]) == mix["batch"] and all(w.dtype == np.float32 for w in x["wavs"])
        frames = [1 + (len(w) - 400) // 160 for w in x["wavs"]]
        assert x["band"] == utterances.serve_band(max(frames), mix["buckets"])
        assert np.isfinite(np.concatenate(x["wavs"])).all()
