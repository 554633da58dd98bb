"""Tiny sizes of the cells for runs on the CPU (tests only): narrow widths,
short utterances, small batches; the structure of each configuration and
mix kept."""

from __future__ import annotations

import copy


def shrink(conf: dict, mix: dict) -> tuple[dict, dict]:
    conf, mix = copy.deepcopy(conf), copy.deepcopy(mix)
    m = conf["model"]
    if m["arch"] == "qlstm":
        m.update(conv_features=[8, 8], lstm_features=16, lstm_layers=2, dense_features=[16])
    else:
        m.update(conv_features=[8, 8, 8], dense_features=[16, 16])
    buckets = [32, 64]
    conf["data"]["bucket_sizes"] = buckets
    mix.update(batch=4, pool_utterances=24, buckets=buckets)
    d = mix["durations"]
    d.update(dist="lognormal", mean_s=0.35, sigma=0.3, min_s=0.1, max_s=0.8)
    if "labels" in mix:
        mix["labels"]["max_len"] = min(mix["labels"]["max_len"], 12)
    return conf, mix


#: the serving cells that wait under PERF.md's open questions (the card sat
#: idle most of their first traced runs), as a later PR would add them: the
#: tests keep their loop, mixes and readers working
SERVE_CELLS = [
    {"name": "librispeech_qlstm.serve", "config": "librispeech_qlstm",
     "traffic": "libri_serve_b32", "chips": 1, "why": "staged"},
    {"name": "timit_qcnn.serve", "config": "timit_qcnn", "traffic": "timit_serve_b16",
     "chips": 1, "why": "staged"},
]


def staged_bench() -> dict:
    """``BENCHMARK.json`` with the serving cells and their metrics added."""
    from qbench import harness

    bench = harness.load_bench()
    names = [c["name"] for c in SERVE_CELLS]
    bench["workloads"] = bench["workloads"] + SERVE_CELLS
    common = {"better": "higher", "bound": 0.05, "source": "host_clock", "workloads": names}
    bench["end_to_end"] = bench["end_to_end"] + [
        {"name": "serve_audio_s_per_s", "unit": "audio-s/s", **common},
        {"name": "serve_p95_ms", "unit": "ms", **common, "better": "lower"}]
    layer = {"better": "higher", "source": "device_trace", "moves": "serve_audio_s_per_s",
             "workloads": names}
    bench["per_layer"] = bench["per_layer"] + [
        {"name": "mfu.serve", "unit": "%", "layer": "serving path", **layer,
         "source": "host_clock"},
        {"name": "qconv_roofline_pct.serve", "unit": "%", "layer": "stacked quaternion convs",
         **layer},
        {"name": "qlstm_roofline_pct.serve", "unit": "%", "layer": "QLSTM recurrence", **layer,
         "workloads": names[:1]},
        {"name": "device_idle_pct.serve", "unit": "%", "layer": "device", **layer,
         "better": "lower"}]
    return bench
