"""What a run may load, how it ends without a card or without the program,
and that a cell, a mix, a loop and a metric are added with files and
entries only."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from conftest import HERE, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "qasr"}


def _python(code: str, cwd: str = ROOT, env: dict | None = None, timeout: int = 600):
    full = {**os.environ, "OMP_NUM_THREADS": "2", **(env or {})}
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=cwd, env=full,
                          capture_output=True, text=True, timeout=timeout)


def test_nothing_loads_jax_or_the_jax_package():
    """The harness, every loop, generator and metric reader, the reference,
    and a whole (tiny, CPU) run of a train and a serve cell: no loaded
    module's top-level name is jax, jaxlib, flax or qasr."""
    r = _python(f"""
        import glob, os, sys
        sys.path[:0] = [{ROOT!r}, {HERE!r}]
        from qbench import harness
        from tiny import shrink, staged_bench
        for sub in ("loops", "traffic", "metrics", "reference"):
            for p in glob.glob(os.path.join(harness.BENCH_DIR, sub, "*.py")):
                harness.load_module(p, "x_" + os.path.basename(p).replace(".", "_"))
        for cell in ("timit_qcnn.train", "librispeech_qlstm.serve"):
            harness.run(cell, 5, 0.2, True, device="cpu", t_start=0.0, shrink=shrink,
                        bench=staged_bench())
        print(sorted({{m.split(".")[0] for m in sys.modules}}))
    """)
    assert r.returncode == 0, r.stderr[-3000:]
    loaded = set(eval(r.stdout.strip().splitlines()[-1]))
    assert "qasr_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    r = _python(f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        import qbench.reference.model, qbench.reference.train, qbench.reference.ctc
        import qbench.reference.frontend, qbench.reference.decode, qbench.reference.precision
        print(sorted({{m.split(".")[0] for m in sys.modules}}))
    """)
    assert r.returncode == 0, r.stderr[-3000:]
    loaded = set(eval(r.stdout.strip().splitlines()[-1]))
    assert not loaded & (FORBIDDEN | {"qasr_torch"})


def test_no_card_no_result():
    r = subprocess.run([sys.executable, "qbench/run.py", "--workload", "timit_qcnn.train",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "qbench"), tmp_path / "qbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "qbench/run.py", "--workload", "timit_qcnn.train",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_a_cell_mix_and_metric_are_added_as_files(tmp_path):
    """In a copy: a new mix (data only), a new metric reader and a new cell
    using both; the unchanged harness finds them by name."""
    shutil.copytree(os.path.join(ROOT, "qbench"), tmp_path / "qbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(tmp_path / "qbench" / "traffic" / "timit_train_b16.json") as f:
        mix = json.load(f)
    mix.update(batch=8, shape_seed=4242)
    with open(tmp_path / "qbench" / "traffic" / "timit_train_b8.json", "w") as f:
        json.dump(mix, f)
    (tmp_path / "qbench" / "metrics" / "steps_per_s.py").write_text(
        'def read(ctx):\n    w = ctx.window\n    return len(w["items"]) / w["seconds"]\n')
    bench["workloads"].append({"name": "timit_qcnn.train_b8", "config": "timit_qcnn",
                               "traffic": "timit_train_b8", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_audio_s_per_s":
            m["workloads"].append("timit_qcnn.train_b8")
    bench["end_to_end"].append({"name": "steps_per_s", "unit": "1/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["timit_qcnn.train_b8"]})
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    r = _python(f"""
        import json, sys
        sys.path[:0] = [{str(tmp_path)!r}, {HERE!r}, {ROOT!r}]
        from qbench import harness
        from tiny import shrink
        assert harness.ROOT == {str(tmp_path)!r}
        res = harness.run("timit_qcnn.train_b8", 3, 0.5, False, device="cpu", t_start=0.0,
                          shrink=shrink)
        print(json.dumps(res["metrics"]))
    """, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    metrics = json.loads(r.stdout.strip().splitlines()[-1])
    assert metrics["steps_per_s"]["value"] > 0
    assert set(metrics) == {"steps_per_s", "train_audio_s_per_s", "setup_s"}


def test_a_loop_is_added_as_a_file(tmp_path):
    """In a copy: a loop that is ``train.py`` under a new name with its own
    ``PROFILE_ITEMS``, a mix that names it, a per-layer metric that counts
    the profiled steps, and a cell using them; the unchanged harness runs the
    cell traced and profiles the loop's own stretch. A loop that states no
    stretch stops at load, naming what it lacks."""
    shutil.copytree(os.path.join(ROOT, "qbench"), tmp_path / "qbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    loops = tmp_path / "qbench" / "loops"
    src = (loops / "train.py").read_text()
    assert "\nPROFILE_ITEMS = 4\n" in src
    (loops / "train_two.py").write_text(src.replace("\nPROFILE_ITEMS = 4\n",
                                                    "\nPROFILE_ITEMS = 2\n"))
    (loops / "train_bare.py").write_text(src.replace("\nPROFILE_ITEMS = 4\n", "\n"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(tmp_path / "qbench" / "traffic" / "timit_train_b16.json") as f:
        mix = json.load(f)
    for loop in ("train_two", "train_bare"):
        with open(tmp_path / "qbench" / "traffic" / f"timit_{loop}.json", "w") as f:
            json.dump({**mix, "loop": loop}, f)
        bench["workloads"].append({"name": f"timit_qcnn.{loop}", "config": "timit_qcnn",
                                   "traffic": f"timit_{loop}", "chips": 1, "why": "test"})
    (tmp_path / "qbench" / "metrics" / "profiled_steps.py").write_text(
        'def read(ctx):\n    return None if ctx.profiled is None else len(ctx.profiled["items"])\n')
    bench["per_layer"].append({"name": "profiled_steps", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "train step",
                               "moves": "train_audio_s_per_s",
                               "workloads": ["timit_qcnn.train_two", "timit_qcnn.train_bare"]})
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    r = _python(f"""
        import json, sys
        sys.path[:0] = [{str(tmp_path)!r}, {HERE!r}, {ROOT!r}]
        from qbench import harness
        from tiny import shrink
        assert harness.ROOT == {str(tmp_path)!r}
        res = harness.run("timit_qcnn.train_two", 3, 0.3, True, device="cpu", t_start=0.0,
                          shrink=shrink)
        print(json.dumps(res["metrics"]))
        try:
            harness.run("timit_qcnn.train_bare", 3, 0.3, True, device="cpu", t_start=0.0,
                        shrink=shrink)
        except SystemExit as e:
            print(json.dumps(str(e)))
    """, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    *_, metrics, stopped = r.stdout.strip().splitlines()
    assert json.loads(metrics) == {"profiled_steps": {"value": 2, "unit": "steps"}}
    assert "loops/train_bare.py" in stopped and "PROFILE_ITEMS" in stopped


@pytest.mark.cuda
def test_a_traced_run_on_the_card(card):
    """A short traced run of each cell on the card: one result line, correct,
    the device named, busy time inside the traced window."""
    for cell in [w["name"] for w in harness_bench()["workloads"]]:
        r = subprocess.run([sys.executable, "qbench/run.py", "--workload", cell, "--seed",
                            "2147483999", "--seconds", "3", "--trace", "1"], cwd=ROOT,
                           capture_output=True, text=True, timeout=900)
        assert r.returncode == 0, r.stderr[-3000:]
        res = json.loads(r.stdout.strip().splitlines()[-1])
        assert res["correct"], res["checks"]
        dev = res["device"]
        assert dev["platform"] == "gpu" and dev["count"] == 1
        assert 0 < dev["busy_s"] <= dev["window_s"]
        assert all(0 < m["value"] <= 100 for m in res["metrics"].values())


def harness_bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)
