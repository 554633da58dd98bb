"""``qasr_torch.parallel`` in gloo worlds of 1, 2 and 4 ranks on the CPU,
against the port's one-process step and the JAX package's sharded functions.

A module fixture writes the inputs (the tiny synthetic qcnn's weights,
initialised by the JAX package and bridged; two batches; a trained copy of
the weights), brings up the three worlds at once (``tests/torch_parallel_worker.py``,
one process a rank, a ``file://`` rendezvous in the test's directory, one
thread a rank), and reads what their rank 0 wrote. The JAX references run
here on the 8-CPU-device mesh of ``tests/conftest.py``, in f32.

Tolerances: ``tests/test_sharding.py``'s (loss and grad norm rtol 1e-5;
params rtol 1e-4, atol 1e-5); a world of one rank gives the one-process
step's bits; the halo conv and the chunked CTC as ``test_sharding.py``
holds JAX's own (5e-4 and rtol 1e-5 / grads rtol 1e-4, atol 1e-6); the
sharded PERs equal the one-process ones.
"""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr.configs import get_config as jget_config
from qasr.ops.ctc import ctc_loss as jctc_loss
from qasr.parallel import create_sharded_train_state as jcreate_sharded
from qasr.parallel import make_mesh as jmake_mesh
from qasr.parallel import make_sharded_train_step as jmake_sharded_step
from qasr.parallel import shard_batch as jshard_batch
from qasr.parallel.seq_parallel import ctc_loss_seq_parallel as jctc_seq
from qasr.parallel.seq_parallel import qconv2d_seq_parallel as jconv_seq
from qasr_torch.bridge import load_params_npz, params_from_jax
from qasr_torch.data.batching import epoch_iterator
from qasr_torch.data.synthetic import SyntheticDataset
from qasr_torch.infer import Transcriber
from qasr_torch.models import build_model
from qasr_torch.parallel.sharding import leaf_spec
from qasr_torch.train.loop import evaluate
from qasr_torch.train.state import create_train_state
from qasr_torch.train.step import train_step
from tests import torch_parallel_worker as worker

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (1, 2, 4)
STEP_TOL = dict(rtol=1e-4, atol=1e-5)  # params, as tests/test_sharding.py
WORLD_TIMEOUT_S = 240


def _jcfg(**extra):
    return jget_config("tiny_synthetic").override(**{**worker.OVERRIDES, **extra})


def _batches(cfg) -> list[dict]:
    ds = SyntheticDataset(vocab=cfg.model.vocab, n_mels=cfg.data.n_mels,
                          num_examples=cfg.data.num_synthetic, seed=0)
    return list(epoch_iterator(ds, cfg.data, train=False))[:2]


def _launch(n: int, directory: str) -> list[subprocess.Popen]:
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    init = f"file://{os.path.join(directory, 'rendezvous')}"
    return [
        subprocess.Popen(
            [sys.executable, "-m", "tests.torch_parallel_worker", "--init", init,
             "--rank", str(r), "--world", str(n), "--dir", directory],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(n)
    ]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs, the one-process references, and the three worlds' results."""
    cfg = worker.tiny_config()
    batches = _batches(cfg)
    jcfg = _jcfg()
    # the JAX package's init, jitted (as its sharded steps' own init is)
    jstate, _ = jcreate_sharded(jcfg, jax.random.PRNGKey(0), batches[0]["features"],
                                jmake_mesh(1, 1, devices=jax.devices()[:1]))
    params = params_from_jax(jax.tree.map(np.asarray, jax.device_get(jstate.params)))
    # a trained copy for the decode cases (an untrained model's beam ties)
    st = create_train_state(cfg.override(**{"train.num_steps": 40}), device="cpu", params=params)
    for i in range(40):
        train_step(st, batches[i % 2])
    trained = {k: v.detach().clone() for k, v in st.model.state_dict().items()}
    arrays = {f"params/{k}": v.numpy() for k, v in params.items()}
    arrays.update({f"trained/{k}": v.numpy() for k, v in trained.items()})
    for i, b in enumerate(batches):
        arrays.update({f"batch{i}/{k}": np.asarray(v) for k, v in b.items()})
    dirs, procs = {}, {}
    for n in WORLDS:
        d = str(tmp_path_factory.mktemp(f"world{n}"))
        np.savez(os.path.join(d, "inputs.npz"), **arrays)
        dirs[n], procs[n] = d, _launch(n, d)
    t0 = time.time()
    logs = {}
    try:
        # the JAX references, while the worlds run
        setup = {"cfg": cfg, "jcfg": jcfg, "params": params,
                 "trained": trained, "batches": batches, "dirs": dirs}
        setup["jax"] = _jax_references(setup)
        for n, ps in procs.items():
            logs[n] = [p.communicate(timeout=max(1, WORLD_TIMEOUT_S - (time.time() - t0)))[0]
                       for p in ps]
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for n, ps in procs.items():
        assert all(p.returncode == 0 for p in ps), f"world {n}:\n" + "\n".join(logs[n])
    return setup


def _jax_references(setup) -> dict:
    """The JAX package's sharded steps, halo convs (with gradients) and
    chunked CTC (with gradients) on meshes of the worlds' sizes, jitted."""
    out = {"steps": {}, "conv": {}, "ctc": {}}
    for n in WORLDS[1:]:
        for nd, nm in worker.STEP_MESHES[n]:
            out["steps"][nd, nm] = _jax_sharded_steps(setup, nd, nm)
        mesh = jmake_mesh(n, 1, devices=jax.devices()[:n])
        for variant, kh, kw, cin, cout in worker.SEQ_CONVS[n]:
            x, w, g = (jnp.asarray(a) for a in worker.seq_conv_inputs(n, variant, kh, kw,
                                                                      cin, cout))
            fwd = jax.jit(lambda x, w, v=variant, m=mesh: jconv_seq(x, w, m, variant=v))
            grad = jax.jit(jax.grad(lambda x, w, g, f=fwd: jnp.sum(f(x, w) * g), argnums=(0, 1)))
            dx, dw = grad(x, w, g)
            out["conv"][n, variant, kh] = tuple(np.asarray(a) for a in (fwd(x, w), dx, dw))
        logits, labels, ll, tl = (jnp.asarray(a) for a in worker.seq_ctc_inputs(n))
        loss = jax.jit(lambda x, m=mesh: jctc_seq(x, labels, ll, tl, m))
        whole = jax.jit(lambda x: jctc_loss(x, labels, ll, tl))
        grad = jax.jit(jax.grad(lambda x, f=loss: f(x).sum()))
        out["ctc"][n] = tuple(np.asarray(a) for a in (loss(logits), whole(logits), grad(logits)))
    return out


def _load(setup, n: int, case: str):
    d = setup["dirs"][n]
    arrays = dict(np.load(os.path.join(d, f"{case}.npz")))
    meta = os.path.join(d, f"{case}.json")
    return arrays, (json.load(open(meta)) if os.path.exists(meta) else None)


def _port_steps(setup, **extra) -> dict:
    """Two one-process port steps from the bridged weights."""
    cfg = worker.tiny_config(**extra)
    st = create_train_state(cfg, device="cpu", params=setup["params"])
    out = {}
    for i, b in enumerate(setup["batches"]):
        m = train_step(st, b)
        out[f"loss{i}"] = m["loss"].numpy()
        out[f"grad_norm{i}"] = m["grad_norm"].numpy()
        out.update({f"params{i}/{k}": v.detach().numpy().copy()
                    for k, v in st.model.state_dict().items()})
    return out


def _jax_sharded_steps(setup, nd: int, nm: int) -> dict:
    """Two steps of the JAX package's sharded step on a (nd, nm) mesh, from
    the same weights (the same seed's init)."""
    jcfg, batches = setup["jcfg"], setup["batches"]
    mesh = jmake_mesh(nd, nm, devices=jax.devices()[:nd * nm])
    state, sh = jcreate_sharded(jcfg, jax.random.PRNGKey(0), batches[0]["features"], mesh)
    step = jmake_sharded_step(jcfg, mesh, sh, batches[0])
    out = {}
    for i, b in enumerate(batches):
        state, m = step(state, jshard_batch(mesh, {k: jnp.asarray(v) for k, v in b.items()}))
        out[f"loss{i}"] = np.asarray(m["loss"])
        out[f"grad_norm{i}"] = np.asarray(m["grad_norm"])
        flat = params_from_jax(jax.tree.map(np.asarray, jax.device_get(state.params)))
        out.update({f"params{i}/{k}": v.numpy() for k, v in flat.items()})
    return out


def _hold(got: dict, want: dict, exact: bool = False) -> None:
    for key, w in want.items():
        if exact:
            np.testing.assert_array_equal(got[key], w, err_msg=key)
        elif key.startswith("params"):
            np.testing.assert_allclose(got[key], w, **STEP_TOL, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], w, rtol=1e-5, err_msg=key)


def test_bridged_weights_are_the_jax_init(setup):
    """The JAX sharded steps start from the weights the worlds load: the
    same seed's init on every mesh."""
    batches = setup["batches"]
    for nd, nm in ((2, 2),):
        mesh = jmake_mesh(nd, nm, devices=jax.devices()[:nd * nm])
        state, _ = jcreate_sharded(setup["jcfg"], jax.random.PRNGKey(0), batches[0]["features"],
                                   mesh)
        flat = params_from_jax(jax.tree.map(np.asarray, jax.device_get(state.params)))
        assert flat.keys() == setup["params"].keys()
        for k, v in setup["params"].items():
            np.testing.assert_array_equal(flat[k].numpy(), v.numpy())


@pytest.mark.parametrize("dropout", [False, True])
def test_world_of_one_gives_the_one_process_bits(setup, dropout):
    extra = {"model.dropout_rate": 0.3} if dropout else {}
    got, _ = _load(setup, 1, "steps_1x1" + ("_dropout" if dropout else ""))
    _hold(got, _port_steps(setup, **extra), exact=True)


@pytest.mark.parametrize("n,nd,nm", [(2, 2, 1), (4, 2, 2)])
def test_sharded_step_matches_one_process_step(setup, n, nd, nm):
    got, _ = _load(setup, n, f"steps_{nd}x{nm}")
    _hold(got, _port_steps(setup))


@pytest.mark.parametrize("n,nd,nm", [(2, 2, 1), (4, 2, 2)])
def test_sharded_step_matches_jax_sharded_step(setup, n, nd, nm):
    got, _ = _load(setup, n, f"steps_{nd}x{nm}")
    _hold(got, setup["jax"]["steps"][nd, nm])


def test_dp_dropout_matches_one_process_step(setup):
    """Each rank draws the global batch's masks and keeps its rows: the DP
    step drops the elements the one-process step drops."""
    got, _ = _load(setup, 2, "steps_2x1_dropout")
    _hold(got, _port_steps(setup, **{"model.dropout_rate": 0.3}))


def test_tp_state_bytes_per_rank(setup):
    """Under TP each rank keeps its Cout slice of every kernel the model axis
    divides (and of its two moments) and the rest whole; the gathered
    kernels are counted beside it."""
    _, meta = _load(setup, 4, "steps_2x2")
    _, whole = _load(setup, 1, "steps_1x1")
    rep = shd = 0
    n_leaves = 0
    for k, v in setup["params"].items():
        n_leaves += 1
        if leaf_spec(_FakeMesh(2), k, v):
            shd += v.numel()
        else:
            rep += v.numel()
    assert shd > 0
    per_rank = 4 * 3 * (rep + shd // 2) + 4 * n_leaves  # params, two moments, step counts
    assert all(p == per_rank for p, _ in meta["state_bytes"]), meta
    assert all(g == 4 * shd for _, g in meta["state_bytes"]), meta
    assert whole["state_bytes"][0] == [4 * 3 * (rep + shd) + 4 * n_leaves, 0]


class _FakeMesh:
    def __init__(self, n_model):
        self.shape = {"data": 1, "model": n_model}


@pytest.mark.parametrize("n,i", [(2, 0), (2, 1), (4, 0), (4, 1)])
def test_halo_conv_matches_jax(setup, n, i):
    variant, kh, kw, _, _ = worker.SEQ_CONVS[n][i]
    got, _ = _load(setup, n, f"seq_{n}")
    y, dx, dw = setup["jax"]["conv"][n, variant, kh]
    key = f"{variant}_{kh}x{kw}"
    np.testing.assert_allclose(got[f"{key}/y"], y, rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(got[f"{key}/dx"], dx, rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(got[f"{key}/dw"], dw, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("n", [2, 4])
def test_chunked_ctc_matches_jax(setup, n):
    """The loss against JAX's chunked loss and its unsharded one (ragged
    lengths), the gradient against JAX's chunked loss's."""
    got, _ = _load(setup, n, f"seq_{n}")
    loss, whole, grad = setup["jax"]["ctc"][n]
    np.testing.assert_allclose(got["ctc/loss"], loss, rtol=1e-5)
    np.testing.assert_allclose(got["ctc/loss"], whole, rtol=1e-5)
    np.testing.assert_allclose(got["ctc/dlogits"], grad, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_beam_per_equals_one_process(setup, n):
    """13 examples in batches of 8: the last batch has 5 real rows, so one
    rank's rows (at 4 ranks, two) are pads; each utterance counts once."""
    _, got = _load(setup, n, f"beam_{n}")
    cfg = worker.tiny_config(**{"data.num_synthetic": 13, "data.batch_size": 8})
    model = build_model(cfg, device="cpu")
    model.load_state_dict(setup["trained"])
    ds = SyntheticDataset(vocab=cfg.model.vocab, n_mels=cfg.data.n_mels, num_examples=13, seed=0)
    for beam, key in ((True, "beam"), (False, "greedy")):
        want = evaluate(cfg, model, ds, beam=beam)
        assert got[key]["per"] == want["per"], (key, got[key], want)
        np.testing.assert_allclose(got[key]["loss"], want["loss"], rtol=1e-5)


def test_tp_checkpoint_resumes_to_the_same_bits(setup):
    """A TP run stopped after step 2 and resumed ends with the uninterrupted
    run's bits (weights and optimizer state); a one-process Transcriber
    serves its checkpoint."""
    d = setup["dirs"][2]
    whole, cut = os.path.join(d, "ckpt_whole", "step_4"), os.path.join(d, "ckpt_cut", "step_4")
    a, b = load_params_npz(os.path.join(whole, "params.npz")), load_params_npz(
        os.path.join(cut, "params.npz"))
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    sa = torch.load(os.path.join(whole, "train_state.pt"), weights_only=True)
    sb = torch.load(os.path.join(cut, "train_state.pt"), weights_only=True)
    assert sa["step"] == sb["step"] == 4
    for i, slot in sa["optimizer"]["state"].items():
        for key, v in slot.items():
            torch.testing.assert_close(v, sb["optimizer"]["state"][i][key], rtol=0, atol=0)
    # the gathered moments have the whole parameters' shapes
    names = list(a)
    for i, slot in sa["optimizer"]["state"].items():
        assert slot["exp_avg"].shape == a[names[int(i)]].shape
    t = Transcriber(cut, device="cpu")
    feats = setup["batches"][0]["features"][:2]
    out = t.model(torch.from_numpy(feats))
    assert out.shape[:2] == feats.shape[:2] and torch.isfinite(out).all()


def test_cli_two_ranks_on_the_cpu(tmp_path):
    """``python -m torch.distributed.run --nproc-per-node 2 -m qasr_torch.cli
    --device cpu`` trains a few steps on gloo; rank 0 alone prints and writes."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    ckpt = tmp_path / "ckpt"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "qasr_torch.cli", "--device", "cpu", "--preset", "tiny_synthetic",
           "--set", "train.num_steps=2", "train.log_every=1", "train.eval_every=2",
           "train.checkpoint_every=2", f"train.checkpoint_dir={ckpt}", "mesh.model_axis=2"]
    p = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=180)
    assert p.returncode == 0, p.stdout + p.stderr
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, p.stdout  # rank 0 only
    last = json.loads(lines[0])
    assert last["step"] == 2 and np.isfinite(last["loss"]) and 0.0 <= last["dev_per"]
    rows = [json.loads(ln) for ln in open(ckpt / "metrics.jsonl")]
    assert [r["step"] for r in rows if "loss" in r] == [1, 2]  # one writer
    assert (ckpt / "step_2" / "params.npz").exists()


def test_cli_config5_tensor_parallel_streams_and_resumes(tmp_path):
    """Config 5 (``librispeech_large``) at its real widths (256-wide convs,
    1024-wide dense layers; depth cut to 2 convs and 1 dense layer, T to
    one 512-frame bucket, f32) on two CPU ranks, TP 2 over gloo, through
    ``python -m torch.distributed.run -m qasr_torch.cli``: streaming
    features from a tiny mini-LibriSpeech, 2 steps with a dev-clean eval and
    a checkpoint, then ``--resume`` for 2 more, which continues from the
    step-2 checkpoint and its data state."""
    from qasr_torch.tools.make_mini_librispeech import write_corpus

    data, ckpt = tmp_path / "libri", tmp_path / "ckpt"
    write_corpus(str(data), speakers=2, utts_per_speaker=2, dev_speakers=1)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    sets = ["model.conv_features=16,256", "model.dense_features=1024",
            "model.compute_dtype=float32", "data.bucket_sizes=512", "data.batch_size=1",
            f"data.data_dir={data}", "train.log_every=1", "train.eval_every=2",
            "train.checkpoint_every=2", f"train.checkpoint_dir={ckpt}", "mesh.model_axis=2"]
    runs = []
    for steps, extra in ((2, []), (4, ["--resume"])):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "2", "-m", "qasr_torch.cli", "--device", "cpu",
               "--preset", "librispeech_large", *extra, "--set", *sets,
               f"train.num_steps={steps}"]
        p = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
        assert p.returncode == 0, p.stdout + p.stderr
        runs.append(p.stdout)
    assert "resumed from step 2" in runs[1]
    last = json.loads([ln for ln in runs[1].splitlines() if ln.startswith("{")][-1])
    assert last["step"] == 4 and np.isfinite(last["loss"]) and 0.0 <= last["dev_per"]
    rows = [json.loads(ln) for ln in open(ckpt / "metrics.jsonl")]
    assert [r["step"] for r in rows if "loss" in r] == [1, 2, 3, 4]
    for step in (2, 4):
        assert (ckpt / f"step_{step}" / "params.npz").exists()
        assert (ckpt / f"data_state_{step}.json").exists()
    assert not (ckpt / "features").exists()  # streaming: no feature cache
