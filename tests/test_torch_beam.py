"""The port's on-device prefix beam (``qasr_torch.decode.beam``) against the
JAX package's (``qasr.decode.beam.ctc_beam_search_decode``) on the same
numpy-seeded logits, on the CPU.

Sequences and lengths must be equal exactly, scores within rtol 1e-5 /
atol 1e-4: both sides run the same f32 operations in the same order, but
``exp``, ``log`` and the log-softmax's sum are other implementations (a few
ulp a frame, accumulated over up to 80 frames of |score| up to ~300).
Tie-heavy logits (all equal, integer-valued) pin the selection's tie order:
``lax.top_k`` keeps the lower index first. The indexed merge is held bit for
bit against the reference's dense ``[W, V, W]`` formula; the port's host
beam (``native``) within the JAX package's own tolerances for it
(``tests/test_beam.py``: rtol 1e-3, atol 2e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr.decode.beam import ctc_beam_search_decode as jbeam
from qasr.decode.scoring import edit_distance as jedit_distance
from qasr.decode.scoring import per_counts as jper_counts
from qasr_torch import decode
from qasr_torch.decode import beam as tbeam
from qasr_torch.decode import ctc_beam_search_decode, ctc_beam_search_decode_host
from qasr_torch.ops.ctc import ctc_greedy_decode
from test_beam import _exhaustive_best

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-4)


def _both(logits, lengths, **kw):
    """(JAX, port) outputs on the same logits, as numpy."""
    want = [np.asarray(a) for a in jbeam(jnp.asarray(logits), jnp.asarray(lengths), **kw)]
    got = [a.numpy() for a in ctc_beam_search_decode(torch.from_numpy(logits),
                                                     torch.from_numpy(lengths), **kw)]
    return want, got


def _assert_same(want, got):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[2], want[2], **TOL)


@pytest.mark.parametrize("prune", [None, -3.0, -20.0])
def test_protocol_width_matches_jax(prune):
    """B=3 ragged lengths (one empty) at W=100, V=62; -3.0 really prunes at
    V=62 (mean log-prob ~ -4.4), -20 is the protocol's threshold."""
    rng = np.random.default_rng(17 if prune is None else int(-prune))
    logits = (rng.standard_normal((3, 48, 62)) * 2.0).astype(np.float32)
    lengths = np.array([48, 41, 0], np.int32)
    want, got = _both(logits, lengths, beam_width=100, max_len=48, prune_logp=prune)
    assert got[1][0] > 5 and got[1][2] == 0 and (got[0][2] == -1).all()
    _assert_same(want, got)


@pytest.mark.parametrize("kind,w,v", [("equal", 100, 62), ("equal", 4, 6),
                                      ("integer", 100, 62), ("integer", 8, 5)])
def test_tie_heavy_logits_match_jax(kind, w, v):
    """All-equal and small-integer logits: every candidate ties with many
    others, so only the selection's tie order decides the beam."""
    rng = np.random.default_rng(3)
    shape = (2, 24, v)
    logits = (np.zeros(shape) if kind == "equal" else rng.integers(-1, 2, shape)).astype(np.float32)
    lengths = np.array([24, 13], np.int32)
    want, got = _both(logits, lengths, beam_width=w, max_len=24, prune_logp=-20.0)
    _assert_same(want, got)


def test_max_len_truncation_and_padding():
    """Increasing one-hot paths cut at max_len = 3 (every 3-token increasing
    subsequence ties: the reference's tie wins), and ragged random rows cut
    at 5; -1 past each length."""
    path = np.array([[1, 0, 2, 0, 3, 0, 4, 0, 5, 0]])
    logits = (np.eye(8, dtype=np.float32)[path] * 12.0)
    want, got = _both(logits, np.array([10], np.int32), beam_width=4, max_len=3)
    assert got[1][0] == 3 and list(got[0][0]) == sorted(got[0][0])
    _assert_same(want, got)
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((3, 30, 9)) * 3.0).astype(np.float32)
    want, got = _both(logits, np.array([30, 12, 2], np.int32), beam_width=8, max_len=5)
    assert got[0].shape == (3, 5) and got[1].max() == 5
    for seq, n in zip(got[0], got[1]):
        assert (seq[n:] == -1).all() and (seq[:n] > 0).all()
    _assert_same(want, got)


def test_peaky_logits_equal_greedy():
    path = np.array([[0, 1, 1, 0, 2, 2, 3, 0, 0, 1], [4, 4, 0, 4, 0, 0, 3, 3, 2, 0]])
    logits = torch.from_numpy(np.eye(5, dtype=np.float32)[path] * 12.0)
    lengths = torch.tensor([10, 7])
    g_seq, g_lens = ctc_greedy_decode(logits, lengths)
    b_seq, b_lens, _ = ctc_beam_search_decode(logits, lengths, beam_width=4, max_len=10)
    assert b_lens.tolist() == g_lens.tolist() == [4, 3]
    for i in range(2):
        assert b_seq[i, : b_lens[i]].tolist() == g_seq[i, : g_lens[i]].tolist()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_exact_on_tiny(seed):
    """W=16 covers every label sequence of T=5, V=3: the beam finds the
    exhaustive path-sum's argmax and its score."""
    logits = (np.random.default_rng(seed).standard_normal((1, 5, 3)) * 2.0).astype(np.float32)
    logp = torch.log_softmax(torch.from_numpy(logits[0]), -1).numpy().astype(np.float64)
    want_seq, want_score = _exhaustive_best(logp, 5, 3, 0, max_len=5)
    seq, lens, score = ctc_beam_search_decode(torch.from_numpy(logits), torch.tensor([5]),
                                              beam_width=16, max_len=5)
    assert tuple(seq[0, : lens[0]].tolist()) == want_seq
    np.testing.assert_allclose(float(score[0]), want_score, rtol=1e-4)


def test_bf16_logits_decode_in_f32():
    rng = np.random.default_rng(6)
    logits = torch.from_numpy(rng.standard_normal((2, 20, 12)).astype(np.float32)).bfloat16()
    kw = dict(beam_width=8, max_len=20, prune_logp=-3.0)
    got = ctc_beam_search_decode(logits, torch.tensor([20, 11]), **kw)
    want = ctc_beam_search_decode(logits.float(), torch.tensor([20, 11]), **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _dense_merge(ext_pnb, hashes):
    """The reference's merge, formula for formula: the ``[W*V, W]`` hash
    equality and the masked logsumexp over every extension."""
    b, w, v = ext_pnb.shape
    tokens = torch.arange(v)
    ext_hash = ((hashes[:, :, None] * 1000003 + tokens + 2) & 0xFFFFFFFF).reshape(b, w * v)
    eq = ext_hash[:, :, None] == hashes[:, None, :]
    contrib = tbeam._masked_logsumexp(ext_pnb.reshape(b, w * v, 1).expand(eq.shape), eq, dim=1)
    return contrib, ~eq.any(dim=2).reshape(b, w, v)


def test_indexed_merge_equals_dense_merge_bit_for_bit():
    """Beam states where slots are extensions of other slots (one extension
    each, one slot receiving two through a constructed hash collision, one
    matching extension pruned to NEG_INF, dead slots)."""
    rng = np.random.default_rng(8)
    b, w, v, mult_inv = 3, 24, 7, pow(1000003, -1, 1 << 32)
    hashes = torch.from_numpy(rng.integers(0, 1 << 32, (b, w), dtype=np.int64))
    ext = torch.from_numpy((rng.standard_normal((b, w, v)) * 3 - 10).astype(np.float32))
    ext[:, :, 0] = tbeam.NEG_INF  # blank
    ext[:, 20:] = tbeam.NEG_INF   # dead parents
    for r in range(b):
        for j in range(10):  # slot j = slot 10 + j extended by token 1 + j % 6
            hashes[r, j] = (hashes[r, 10 + j] * 1000003 + 1 + j % 6 + 2) & 0xFFFFFFFF
        # slot 21 (a dead parent) collides with slot 10 + 0 on token 4 -> 1
        hashes[r, 21] = (hashes[r, 10] - 3 * mult_inv) & 0xFFFFFFFF
    ext[1, 13, 4] = tbeam.NEG_INF  # slot 3's only extension, pruned
    ext[2, 21, 4] = -11.5          # the colliding pair: two finite terms for slot 0
    got = tbeam._merge(ext, hashes)
    want = _dense_merge(ext, hashes)
    assert (want[0] > tbeam.NEG_INF / 2).sum() >= 20 and (~want[1]).sum() >= 30
    assert want[0][2, 0] > ext[2, 10, 1] and not want[1][2, 21, 4]  # two terms summed
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("prune", [None, -20.0])
def test_host_beam_matches_device_beam(prune):
    """``ctc_beam_search_decode_host`` (the port's native C++ beam, no
    fallback) against the device beam at W=100, V=62."""
    rng = np.random.default_rng(23)
    logits = (rng.standard_normal((3, 40, 62)) * 2.0).astype(np.float32)
    lengths = torch.tensor([40, 33, 20])
    kw = dict(beam_width=100, max_len=40, prune_logp=prune)
    d_seq, d_lens, d_score = ctc_beam_search_decode(torch.from_numpy(logits), lengths, **kw)
    n_seq, n_lens, n_score = ctc_beam_search_decode_host(torch.from_numpy(logits), lengths, **kw)
    assert isinstance(n_seq, np.ndarray)
    np.testing.assert_array_equal(n_lens, d_lens.numpy())
    np.testing.assert_array_equal(n_seq, d_seq.numpy())
    np.testing.assert_allclose(n_score, d_score.numpy(), rtol=1e-3, atol=2e-3)


def test_decode_exports_and_scoring_match_reference():
    """``qasr_torch.decode`` exports what ``qasr.decode`` does; its
    ``edit_distance`` and ``per_counts`` give the reference's counts, on id
    and on phone-string sequences."""
    import qasr.decode as jdecode

    assert sorted(decode.__all__) == sorted(jdecode.__all__)
    rng = np.random.default_rng(2)
    for _ in range(20):
        ref, hyp = rng.integers(1, 62, rng.integers(0, 15)), rng.integers(1, 62, rng.integers(0, 15))
        assert decode.edit_distance(ref, hyp) == jedit_distance(ref, hyp)
        for fold in (True, False):
            assert decode.per_counts(ref, hyp, fold=fold) == jper_counts(ref, hyp, fold=fold)
    ref, hyp = "sil n m dh aa".split(), "sil n dh aa aa".split()
    assert decode.edit_distance(ref, hyp) == jedit_distance(ref, hyp) == 2
