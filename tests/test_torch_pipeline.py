"""The port's corpus readers, feature pipeline and dev-split evaluation
against the JAX package, on small corpora written by ``tools/make_mini_timit.py``
and ``tools/make_mini_librispeech.py`` (2-3 speakers a split).

- ``TimitDataset`` and ``LibriSpeechDataset`` index the same utterances in
  the same order for every split (the TIMIT dev fallback too), and
  ``load(i)`` gives equal arrays;
- the cached, streaming and block-prefetch features equal the JAX
  pipeline's within rtol/atol 1e-4 (the front end's tolerance: log-mel of a
  400 x 257 DFT matmul summed in another order; the port pads a block to its
  longest waveform, the JAX package to a power of two);
- a cache written by either package loads in the other bit for bit;
- ``epoch_iterator`` over the port's pipeline gives the reference's batches
  (labels, lengths and ``real_rows`` exactly, features within 1e-4), with the
  same announcements of the epoch order;
- the slice as a whole: with one set of weights carried across by
  ``params_from_jax`` (``timit_qcnn_fm32`` narrowed to three conv layers),
  the port's ``evaluate`` on the dev split equals the JAX ``evaluate`` (PER
  exactly, loss within 1e-4 relative), and ``train()`` logs the dev split's
  PER;
- the port's corpus writers (``qasr_torch/tools/make_mini_*.py``) write the
  same bytes as the repo's tools.
"""

import filecmp
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from qasr.configs import get_config as jget_config
from qasr.data.batching import bucketed_batches as jbucketed_batches
from qasr.data.batching import epoch_iterator as jepoch_iterator
from qasr.data.librispeech import LibriSpeechDataset as JLibriSpeechDataset
from qasr.data.pipeline import LibriFeaturePipeline as JLibriFeaturePipeline
from qasr.data.pipeline import TimitFeaturePipeline as JTimitFeaturePipeline
from qasr.data.timit import DEV_SPEAKERS
from qasr.data.timit import TimitDataset as JTimitDataset
from qasr.train import evaluate as jevaluate
from qasr.train import make_eval_step
from qasr.train.state import create_train_state as jcreate_train_state
from qasr_torch.bridge import params_from_jax, params_to_jax
from qasr_torch.configs import get_config
from qasr_torch.data.batching import bucketed_batches, epoch_iterator
from qasr_torch.data.librispeech import LibriSpeechDataset
from qasr_torch.data.pipeline import LibriFeaturePipeline, TimitFeaturePipeline
from qasr_torch.data.timit import TimitDataset
from qasr_torch.models import build_model
from qasr_torch.train.loop import build_eval_dataset, evaluate, train

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
TIMIT_ARGS = ["--train-speakers", "3", "--utts-per-speaker", "4", "--dev-speakers", "2",
              "--test-speakers", "2", "--seed", "0"]
LIBRI_ARGS = ["--speakers", "2", "--utts-per-speaker", "4", "--dev-speakers", "2", "--seed", "0"]


def _run(args):
    subprocess.run([sys.executable, *args], cwd=REPO, check=True, capture_output=True,
                   timeout=300, env={**os.environ, "PYTHONPATH": REPO})


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """mini-TIMIT and mini-LibriSpeech written by the repo's tools, and a
    TIMIT copy whose dev speakers are renamed off the standard list (so
    ``dev`` falls back to the non-core test speakers)."""
    root = tmp_path_factory.mktemp("corpora")
    timit, libri, fallback = root / "timit", root / "libri", root / "timit_fallback"
    _run(["tools/make_mini_timit.py", "--out", str(timit), *TIMIT_ARGS])
    _run(["tools/make_mini_librispeech.py", "--out", str(libri), *LIBRI_ARGS])
    shutil.copytree(timit, fallback)
    renamed = 0
    for dirpath, dirnames, _ in list(os.walk(fallback / "test")):
        for d in dirnames:
            if d in DEV_SPEAKERS:
                os.rename(os.path.join(dirpath, d), os.path.join(dirpath, f"x{d[1:]}"))
                renamed += 1
    assert renamed == 2
    return {"timit": str(timit), "libri": str(libri), "fallback": str(fallback)}


def _cfgs(name, **over):
    return jget_config(name).override(**over), get_config(name).override(**over)


# ---------------------------------------------------------------------------
# corpus readers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("root,split", [
    ("timit", "train"), ("timit", "dev"), ("timit", "core_test"), ("timit", "full_test"),
    ("fallback", "dev"), ("libri", "train-clean-100"), ("libri", "dev-clean"),
])
def test_datasets_index_and_load_like_reference(corpora, root, split):
    if root == "libri":
        jds, tds = JLibriSpeechDataset(corpora[root], split), LibriSpeechDataset(corpora[root], split)
        assert [(u.audio_path, u.text) for u in tds.utterances] == \
            [(u.audio_path, u.text) for u in jds.utterances]
    else:
        jds, tds = JTimitDataset(corpora[root], split), TimitDataset(corpora[root], split)
        assert [(u.wav_path, u.phn_path, u.speaker, u.split) for u in tds.utterances] == \
            [(u.wav_path, u.phn_path, u.speaker, u.split) for u in jds.utterances]
    assert len(tds) == len(jds) >= 4
    for i in range(len(tds)):
        (tw, tl), (jw, jl) = tds.load(i), jds.load(i)
        assert tw.dtype == jw.dtype and tl.dtype == jl.dtype
        np.testing.assert_array_equal(tw, jw)
        np.testing.assert_array_equal(tl, jl)


def test_dev_split_and_missing_corpora(corpora, tmp_path):
    """The mini corpus's dev split holds the standard dev speakers only; the
    fallback holds the non-core test speakers; missing roots, splits and
    empty splits raise the reference's ``FileNotFoundError``s."""
    dev = TimitDataset(corpora["timit"], "dev")
    assert len(dev) == 8 and {u.speaker for u in dev.utterances} == set(sorted(DEV_SPEAKERS)[:2])
    assert {u.speaker[0] for u in TimitDataset(corpora["fallback"], "dev").utterances} == {"x"}
    cases = [(TimitDataset, JTimitDataset, (str(tmp_path / "none"),)),
             (TimitDataset, JTimitDataset, (str(tmp_path),)),
             (LibriSpeechDataset, JLibriSpeechDataset, (corpora["libri"], "test-clean")),
             (LibriSpeechDataset, JLibriSpeechDataset, (str(tmp_path), ""))]
    for tcls, jcls, args in cases:
        with pytest.raises(FileNotFoundError) as want:
            jcls(*args)
        with pytest.raises(FileNotFoundError) as got:
            tcls(*args)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# features
# ---------------------------------------------------------------------------


def _pipelines(corpora, corpus, split, tmp_path, cache_features):
    over = {"data.data_dir": corpora[corpus], "data.cache_features": cache_features}
    if corpus == "timit":
        jcfg, tcfg = _cfgs("timit_qcnn", **over)
        jcls, tcls = JTimitFeaturePipeline, TimitFeaturePipeline
    else:
        jcfg, tcfg = _cfgs("librispeech_qlstm", **over)
        jcls, tcls = JLibriFeaturePipeline, LibriFeaturePipeline
    jp = jcls(jcfg, split, cache_dir=str(tmp_path / "jax"))
    tp = tcls(tcfg, split, cache_dir=str(tmp_path / "torch"), device="cpu")
    return jp, tp


def _same_example(a, b, tol=TOL):
    assert a.features.shape == b.features.shape and a.features.dtype == b.features.dtype
    np.testing.assert_allclose(b.features, a.features, **tol)
    np.testing.assert_array_equal(b.labels, a.labels)
    assert b.labels.dtype == a.labels.dtype


@pytest.mark.parametrize("corpus,split", [("timit", "train"), ("libri", "dev-clean")])
@pytest.mark.parametrize("mode", ["cached", "streaming", "block_prefetch"])
def test_features_match_reference(corpora, tmp_path, corpus, split, mode):
    jp, tp = _pipelines(corpora, corpus, split, tmp_path, mode == "cached")
    assert len(jp) == len(tp)
    if mode == "block_prefetch":
        order = np.random.RandomState(0).permutation(len(tp))
        jp.prefetch(order)
        tp.prefetch(order)
        assert sorted(tp._stream_cache) == sorted(range(len(tp)))
    else:
        order = range(len(tp))
    for i in order:
        _same_example(jp[i], tp[i])
    if mode == "cached":
        assert os.path.basename(tp.cache_path) == os.path.basename(jp.cache_path)
        assert not tp.cache_hit
    else:
        assert tp._stream_cache == {} and not os.path.exists(tp.cache_path)


def test_features_do_not_depend_on_padding(corpora, tmp_path):
    """One block of every utterance and one block each give the same
    features within the tolerance (the block pads to its longest)."""
    _, tp = _pipelines(corpora, "timit", "dev", tmp_path, False)
    loaded = [tp.corpus.load(i) for i in range(len(tp))]
    block = tp.featurize(loaded)
    for i, ex in enumerate(block):
        _same_example(ex, tp.featurize([loaded[i]])[0])


def test_caches_interchange_bit_for_bit(corpora, tmp_path):
    """A cache the JAX package wrote loads in the port, and the port's in
    the JAX package, giving the writer's examples bit for bit."""
    over = {"data.data_dir": corpora["timit"]}
    jcfg, tcfg = _cfgs("timit_qcnn", **over)
    jax_dir, torch_dir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jwrote = JTimitFeaturePipeline(jcfg, "dev", cache_dir=jax_dir)
    tread = TimitFeaturePipeline(tcfg, "dev", cache_dir=jax_dir, device="cpu")
    assert tread.cache_hit and len(tread) == len(jwrote)
    twrote = TimitFeaturePipeline(tcfg, "dev", cache_dir=torch_dir, device="cpu")
    jread = JTimitFeaturePipeline(jcfg, "dev", cache_dir=torch_dir)
    assert not twrote.cache_hit and os.listdir(torch_dir) == [os.path.basename(twrote.cache_path)]
    for (writer, reader) in ((jwrote, tread), (twrote, jread)):
        for i in range(len(writer)):
            _same_example(writer[i], reader[i], tol=dict(rtol=0, atol=0))
    data = np.load(twrote.cache_path, allow_pickle=True)
    assert data["features"].dtype == object and data["features"].shape == (len(twrote),)


class _Recorder:
    """A (features, labels) sequence that records the prefetch calls."""

    def __init__(self, lengths):
        self.lengths = lengths
        self.calls = []

    def __len__(self):
        return len(self.lengths)

    def __getitem__(self, i):
        return np.zeros((self.lengths[i], 2, 4), np.float32), np.array([1], np.int32)

    def prefetch(self, indices):
        self.calls.append([int(i) for i in indices])


@pytest.mark.parametrize("batch_size", [4, 20])
def test_bucketed_batches_announce_order_like_reference(batch_size):
    lengths = list(np.random.RandomState(1).randint(5, 60, size=45))
    kw = dict(batch_size=batch_size, bucket_sizes=(16, 64), max_label_len=3, seed=3)
    jrec, trec = _Recorder(lengths), _Recorder(lengths)
    jn = len(list(jbucketed_batches(jrec, **kw)))
    tn = len(list(bucketed_batches(trec, **kw)))
    assert tn == jn and trec.calls == jrec.calls
    assert len(trec.calls) == -(-45 // max(batch_size, 16))


@pytest.mark.parametrize("train_mode", [True, False])
def test_epoch_iterator_matches_reference(corpora, tmp_path, train_mode):
    over = {"data.data_dir": corpora["timit"], "data.batch_size": 4,
            "data.cache_features": False}
    jcfg, tcfg = _cfgs("timit_qcnn", **over)
    jp = JTimitFeaturePipeline(jcfg, "train")
    tp = TimitFeaturePipeline(tcfg, "train", device="cpu")
    jb = list(jepoch_iterator(jp, jcfg.data, seed=5, train=train_mode))
    tb = list(epoch_iterator(tp, tcfg.data, seed=5, train=train_mode))
    assert len(tb) == len(jb) >= 2
    for a, b in zip(jb, tb):
        assert set(a) == set(b)
        for k in ("labels", "feature_lengths", "label_lengths", "real_rows"):
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        np.testing.assert_allclose(b["features"], a["features"], **TOL)
    assert tp._stream_cache == {}
    assert any(not b["real_rows"].all() for b in tb) != train_mode
    with pytest.raises(NotImplementedError, match="qasr_torch.data.pipeline"):
        epoch_iterator(TimitDataset(corpora["timit"], "train"), tcfg.data)


# ---------------------------------------------------------------------------
# the slice as a whole: dev-split evaluation against the JAX package
# ---------------------------------------------------------------------------

SLICE = {"model.conv_features": (32, 32, 32), "model.dense_features": (64,),
         "model.compute_dtype": "float32", "model.dropout_rate": 0.0, "data.batch_size": 4,
         "data.bucket_sizes": (128, 256)}


def _own_copy(corpora, tmp_path) -> str:
    """A copy of mini-TIMIT whose ``.qasr_cache`` this test owns."""
    root = str(tmp_path / "timit")
    shutil.copytree(corpora["timit"], root)
    return root


def test_dev_evaluate_matches_reference(corpora, tmp_path):
    """timit_qcnn_fm32 narrowed to three conv layers, JAX-initialised weights
    carried into the port: the port's eval set is the dev split, and its
    ``evaluate`` there equals the JAX ``evaluate`` on the same features (the
    JAX pipeline reads the port's cache): PER exactly, loss 1e-4."""
    root = _own_copy(corpora, tmp_path)
    jcfg, tcfg = _cfgs("timit_qcnn_fm32", **SLICE, **{"data.data_dir": root})
    tds = build_eval_dataset(tcfg, device="cpu")
    assert [u.wav_path for u in tds.corpus.utterances] == \
        [u.wav_path for u in JTimitDataset(root, "dev").utterances]
    jds = JTimitFeaturePipeline(jcfg, "dev")
    sample = next(iter(jepoch_iterator(jds, jcfg.data, train=False)))["features"]
    jstate = jax.jit(lambda f: jcreate_train_state(jcfg, jax.random.PRNGKey(0), f))(sample)
    jparams = jax.tree.map(np.array, jstate.params)
    want = jevaluate(jcfg, jparams, jds, make_eval_step(jcfg))
    model = build_model(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jparams))
    got = evaluate(tcfg, model, tds)
    assert got["per"] == want["per"] and 0.0 < got["per"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)


def test_train_logs_the_dev_split_per(corpora, tmp_path):
    """``train()`` on mini-TIMIT evaluates on the dev split: the ``dev_per``
    it logs at its checkpoint equals the JAX ``evaluate`` of that
    checkpoint's weights on the dev split, and the feature cache is built
    once and then read."""
    root = _own_copy(corpora, tmp_path)
    ckpt = str(tmp_path / "ckpt")
    over = {**SLICE, "data.data_dir": root, "train.num_steps": 2,
            "train.eval_every": 2, "train.log_every": 1, "train.checkpoint_every": 2,
            "train.learning_rate": 1e-3, "train.warmup_steps": 1}
    jcfg, tcfg = _cfgs("timit_qcnn_fm32", **over)
    state, last = train(tcfg, device="cpu", checkpoint_dir=ckpt)
    assert state.step == 2 and last["checkpoint"] == os.path.join(ckpt, "step_2")
    cache_dir = os.path.join(root, ".qasr_cache")
    assert len(os.listdir(cache_dir)) == 2  # train and dev
    assert TimitFeaturePipeline(tcfg, "dev", device="cpu").cache_hit
    jds = JTimitFeaturePipeline(jcfg, "dev")  # reads the port's cache
    jparams = jax.tree.map(np.asarray, params_to_jax(state.model.state_dict()))
    want = jevaluate(jcfg, jparams, jds, make_eval_step(jcfg))
    assert last["dev_per"] == want["per"]
    np.testing.assert_allclose(last["dev_loss"], want["loss"], rtol=1e-4)


# ---------------------------------------------------------------------------
# the port's corpus writers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tool,args", [("make_mini_timit", TIMIT_ARGS),
                                       ("make_mini_librispeech", LIBRI_ARGS)])
def test_port_writers_match_repo_tools(tmp_path, tool, args):
    repo_out, port_out = tmp_path / "repo", tmp_path / "port"
    _run([f"tools/{tool}.py", "--out", str(repo_out), *args])
    _run(["-m", f"qasr_torch.tools.{tool}", "--out", str(port_out), *args])
    files = sorted(os.path.relpath(os.path.join(d, f), repo_out)
                   for d, _, fs in os.walk(repo_out) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), port_out)
                           for d, _, fs in os.walk(port_out) for f in fs)
    assert len(files) >= 12
    _, mismatch, errors = filecmp.cmpfiles(repo_out, port_out, files, shallow=False)
    assert not mismatch and not errors
