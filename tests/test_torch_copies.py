"""The port's own copies of the JAX package's framework-free modules stay
equal to the originals: configs and presets, the TIMIT and LibriSpeech
tables (the speaker lists too), the audio reader and writer, the ``.phn``
reader, PER scoring and the native C++ library (built
from the port's copy of the sources into ``qasr_torch/_build/``).
"""

import dataclasses
import json
import struct
import wave

import numpy as np
import pytest

import qasr.configs as jconfigs
import qasr.data.librispeech as jlibri
import qasr.data.timit as jtimit
import qasr.decode.scoring as jscoring
import qasr.native as jnative
import qasr_torch.configs as tconfigs
import qasr_torch.data.librispeech as tlibri
import qasr_torch.data.timit as ttimit
import qasr_torch.decode.scoring as tscoring
import qasr_torch.native as tnative


def test_presets_equal_reference():
    assert sorted(tconfigs.PRESETS) == sorted(jconfigs.PRESETS)
    for name, cfg in jconfigs.PRESETS.items():
        assert dataclasses.asdict(tconfigs.PRESETS[name]) == dataclasses.asdict(cfg), name
        assert tconfigs.get_config(name).name == name
    with pytest.raises(KeyError):
        tconfigs.get_config("no_such_preset")


def test_jax_config_json_loads_and_round_trips():
    """A ``config.json`` as JAX training writes it loads into the port's
    ``Config`` and writes back the same JSON; overrides agree."""
    over = {"model.conv_features": (8, 16), "data.bucket_sizes": (64, 128),
            "train.num_steps": 7, "decode.beam_prune_logp": None}
    for name in ("timit_qcnn", "tiny_synthetic", "librispeech_large"):
        jcfg = jconfigs.get_config(name).override(**over)
        tcfg = tconfigs.Config.from_json(jcfg.to_json())
        assert tcfg == tconfigs.get_config(name).override(**over)
        assert json.loads(tcfg.to_json()) == json.loads(jcfg.to_json())
        assert tconfigs.Config.from_json(tcfg.to_json()) == tcfg


def test_phone_tables_and_fold_equal_reference():
    assert ttimit.TIMIT_61 == jtimit.TIMIT_61
    assert ttimit.FOLD_61_TO_39 == jtimit.FOLD_61_TO_39
    assert ttimit.PHONE_TO_ID == jtimit.PHONE_TO_ID
    assert ttimit.ID_TO_PHONE == jtimit.ID_TO_PHONE
    assert ttimit.CORE_TEST_SPEAKERS == jtimit.CORE_TEST_SPEAKERS
    assert ttimit.DEV_SPEAKERS == jtimit.DEV_SPEAKERS
    assert len(ttimit.DEV_SPEAKERS) == 50 and not ttimit.DEV_SPEAKERS & ttimit.CORE_TEST_SPEAKERS
    phones = jtimit.TIMIT_61 + ["not-a-phone"]
    assert ttimit.fold_to_39(phones) == jtimit.fold_to_39(phones)
    assert tscoring.FOLDED_39 == jscoring.FOLDED_39
    ids = list(range(0, 64))
    assert tscoring.fold_ids_to_39_ids(ids) == jscoring.fold_ids_to_39_ids(ids)
    assert tlibri.CHAR_VOCAB == jlibri.CHAR_VOCAB and tlibri.VOCAB_SIZE == jlibri.VOCAB_SIZE
    text = "it's A test"
    np.testing.assert_array_equal(tlibri.text_to_ids(text), jlibri.text_to_ids(text))
    assert tlibri.ids_to_text(range(35)) == jlibri.ids_to_text(range(35))


def test_audio_reader_equals_reference(tmp_path):
    rng = np.random.default_rng(0)
    pcm = (rng.standard_normal(1234) * 3000).astype("<i2")
    riff = tmp_path / "a.wav"
    with wave.open(str(riff), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    header = (b"NIST_1A\n   1024\nsample_count -i 1000\nsample_rate -i 8000\n"
              b"sample_byte_format -s2 01\nend_head\n")
    sph = tmp_path / "b.wav"
    sph.write_bytes(header.ljust(1024, b" ") + pcm.tobytes())
    for path in (riff, sph):
        got, got_rate = ttimit.read_sphere(str(path))
        want, want_rate = jtimit.read_sphere(str(path))
        assert got_rate == want_rate and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    bad = tmp_path / "c.wav"
    bad.write_bytes(b"RIFF" + struct.pack("<I", 4) + b"JUNK")
    with pytest.raises(ValueError):
        ttimit.read_sphere(str(bad))


def test_riff_writer_and_phn_reader_equal_reference(tmp_path):
    """``write_riff`` writes the reference's bytes (and reads back through
    ``read_sphere``); ``read_phn`` reads a transcript as the reference does
    (lower-cased symbols, malformed lines skipped)."""
    pcm = (np.random.default_rng(3).standard_normal(777) * 4000).astype(np.int16)
    for rate in (16000, 8000):
        ttimit.write_riff(str(tmp_path / "t.wav"), pcm, rate)
        jtimit.write_riff(str(tmp_path / "j.wav"), pcm, rate)
        assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
        got, got_rate = ttimit.read_sphere(str(tmp_path / "t.wav"))
        assert got_rate == rate
        np.testing.assert_array_equal(got, pcm)
    phn = tmp_path / "a.phn"
    phn.write_text("0 3050 h#\n3050 4559 SH\nbad line\n4559 5723 ix extra\n5723 6000 q\n\n")
    assert ttimit.read_phn(str(phn)) == jtimit.read_phn(str(phn)) == ["h#", "sh", "q"]


@pytest.mark.parametrize("fold", [True, False])
def test_batch_per_equals_reference(fold):
    rng = np.random.default_rng(1)
    refs = rng.integers(1, 62, size=(6, 15))
    hyps = rng.integers(1, 62, size=(6, 12))
    ref_lens = rng.integers(0, 16, size=6)
    hyp_lens = rng.integers(0, 13, size=6)
    got = tscoring.batch_per(refs, ref_lens, hyps, hyp_lens, fold=fold)
    assert got == jscoring.batch_per(refs, ref_lens, hyps, hyp_lens, fold=fold)
    assert got[1] > 0


def test_native_library_builds_in_port_tree():
    """The port's native library comes from its own sources and lands in
    ``qasr_torch/_build/``, never in the JAX package's directory."""
    tnative.edit_distance_native([1, 2, 3], [1, 3])
    assert tnative.LIB_PATH.endswith("qasr_torch/_build/libqasr_native.so")
    for name in ("beam_decode.cpp", "edit_distance.cpp", "flac_decode.cpp"):
        with open(f"{tnative._DIR}/{name}") as a, open(f"{jnative._DIR}/{name}") as b:
            assert a.read() == b.read(), name
    rng = np.random.default_rng(2)
    for _ in range(20):
        r = rng.integers(0, 5, size=rng.integers(0, 12)).tolist()
        h = rng.integers(0, 5, size=rng.integers(0, 12)).tolist()
        assert tnative.edit_distance_native(r, h) == jnative.edit_distance_native(r, h)
