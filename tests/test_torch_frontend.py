"""qasr_torch front-end against qasr.features on ragged-length waveforms.

Numpy-seeded waveforms go through both packages in f32. Tolerance:
rtol/atol 1e-4 on normalized features (log-mel of a 400x257 DFT matmul, then
three delta passes and CMVN, all f32 in another summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr.features import frontend as jfe
from qasr_torch.features import frontend as tfe

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)


def test_tables_match_reference():
    cfg = tfe.FrontendConfig(n_mels=16)
    jcfg = jfe.FrontendConfig(n_mels=16)
    np.testing.assert_array_equal(tfe.mel_filterbank(cfg), jfe.mel_filterbank(jcfg))
    for a, b in zip(tfe.dft_matrices(cfg), jfe.dft_matrices(jcfg)):
        np.testing.assert_array_equal(a, b)
    assert tfe.num_frames(16000, cfg) == jfe.num_frames(16000, jcfg)


@pytest.mark.parametrize("n_samples", [400, 4321, 16000, 23457])
@pytest.mark.parametrize("n_mels", [8, 40])
def test_featurize_waveform_matches_reference(n_samples, n_mels):
    wav = (np.random.default_rng(n_samples).standard_normal(n_samples) * 0.1).astype(np.float32)
    want = jfe.featurize_waveform(wav, jfe.FrontendConfig(n_mels=n_mels))
    got = tfe.featurize_waveform(wav, tfe.FrontendConfig(n_mels=n_mels), device="cpu")
    assert got.shape == want.shape == (tfe.num_frames(n_samples, tfe.FrontendConfig()), n_mels, 4)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_delta_clamps_at_lengths():
    rng = np.random.default_rng(0)
    feat = rng.standard_normal((3, 12, 5)).astype(np.float32)
    lengths = np.array([12, 7, 1], np.int32)
    want = np.asarray(jfe.delta(jnp.asarray(feat), 2, jnp.asarray(lengths)))
    got = tfe.delta(torch.from_numpy(feat), 2, torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    want = np.asarray(jfe.normalize_features(jnp.asarray(feat), jnp.asarray(lengths)))
    got = tfe.normalize_features(torch.from_numpy(feat), torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_waveform_shorter_than_a_window_has_no_frames():
    wav = np.ones(399, np.float32)
    want = jfe.featurize_waveform(wav, jfe.FrontendConfig(n_mels=8))
    got = tfe.featurize_waveform(wav, tfe.FrontendConfig(n_mels=8), device="cpu")
    assert got.shape == want.shape == (0, 8, 4)
