"""TIMIT corpus reader: the phone inventory, the 61->39 fold, the standard
speaker lists, the SPHERE/RIFF reader and writer, ``.phn`` transcripts and
``TimitDataset`` (the port's own copy of ``qasr/data/timit.py``; tests hold
the tables, the readers and the split indexing equal to the reference's).

Layout: ``<root>/{train,test}/<dialect>/<speaker>/<utt>.{wav,phn}``
(case-insensitive). Constructing ``TimitDataset`` on a missing corpus raises
``FileNotFoundError``; ``qasr_torch.tools.make_mini_timit`` writes a small
corpus in this layout.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

# The 61 TIMIT phones (training inventory), in canonical order. Blank for CTC
# is a separate symbol at index 0; phones occupy ids 1..61.
TIMIT_61 = [
    "aa", "ae", "ah", "ao", "aw", "ax", "ax-h", "axr", "ay", "b", "bcl",
    "ch", "d", "dcl", "dh", "dx", "eh", "el", "em", "en", "eng", "epi",
    "er", "ey", "f", "g", "gcl", "h#", "hh", "hv", "ih", "ix", "iy", "jh",
    "k", "kcl", "l", "m", "n", "ng", "nx", "ow", "oy", "p", "pau", "pcl",
    "q", "r", "s", "sh", "t", "tcl", "th", "uh", "uw", "ux", "v", "w",
    "y", "z", "zh",
]
assert len(TIMIT_61) == 61, "TIMIT training inventory must be exactly 61 phones"

# Lee & Hon 61 -> 39 folding used for TIMIT PER scoring. 'q' is deleted.
FOLD_61_TO_39 = {
    "aa": "aa", "ao": "aa",
    "ah": "ah", "ax": "ah", "ax-h": "ah",
    "er": "er", "axr": "er",
    "hh": "hh", "hv": "hh",
    "ih": "ih", "ix": "ih",
    "l": "l", "el": "l",
    "m": "m", "em": "m",
    "n": "n", "en": "n", "nx": "n",
    "ng": "ng", "eng": "ng",
    "sh": "sh", "zh": "sh",
    "uw": "uw", "ux": "uw",
    "pcl": "sil", "tcl": "sil", "kcl": "sil", "bcl": "sil", "dcl": "sil",
    "gcl": "sil", "h#": "sil", "pau": "sil", "epi": "sil",
    "q": None,
    # identity for the rest
    "ae": "ae", "aw": "aw", "ay": "ay", "b": "b", "ch": "ch", "d": "d",
    "dh": "dh", "dx": "dx", "eh": "eh", "ey": "ey", "f": "f", "g": "g",
    "iy": "iy", "jh": "jh", "k": "k", "ow": "ow", "oy": "oy", "p": "p",
    "r": "r", "s": "s", "t": "t", "th": "th", "uh": "uh", "v": "v",
    "w": "w", "y": "y", "z": "z",
}

PHONE_TO_ID = {p: i + 1 for i, p in enumerate(TIMIT_61)}  # 0 = CTC blank
ID_TO_PHONE = {i: p for p, i in PHONE_TO_ID.items()}

# TIMIT core test set speakers (24 speakers, standard protocol).
CORE_TEST_SPEAKERS = {
    "mdab0", "mwbt0", "felc0", "mtas1", "mwew0", "fpas0", "mjmp0", "mlnt0",
    "fpkt0", "mlll0", "mtls0", "fjlm0", "mbpm0", "mklt0", "fnlp0", "mcmj0",
    "mjdh0", "fmgd0", "mgrt0", "mnjm0", "fdhc0", "mjln0", "mpam0", "fmld0",
}

# Standard 50-speaker development set (the Kaldi TIMIT recipe's dev_spk.list),
# disjoint from the core test speakers. If a corpus directory contains none
# of these (e.g. a partial corpus), split="dev" falls back to all non-core
# test speakers.
DEV_SPEAKERS = {
    "faks0", "fdac1", "fjem0", "mgwt0", "mjar0", "mmdb1", "mmdm2", "mpdf0",
    "fcmh0", "fkms0", "mbdg0", "mbwm0", "mcsh0", "fadg0", "fdms0", "fedw0",
    "mgjf0", "mglb0", "mrtk0", "mtaa0", "mtdt0", "mthc0", "mwjg0", "fnmr0",
    "frew0", "fsem0", "mbns0", "mmjr0", "mdls0", "mdlf0", "mdvc0", "mers0",
    "fmah0", "fdrw0", "mrcs0", "mrjm4", "fcal1", "mmwh0", "fjsj0", "majc0",
    "mjsw0", "mreb0", "fgjd0", "fjmg0", "mroa0", "mteb0", "mjfc0", "mrjr0",
    "fmml0", "mrws1",
}


def fold_to_39(phones: list[str]) -> list[str]:
    """Apply the Lee & Hon 61->39 folding; 'q' deleted, glottal-collapsed."""
    out = []
    for p in phones:
        m = FOLD_61_TO_39.get(p, p)
        if m is not None:
            out.append(m)
    return out


def read_sphere(path: str) -> tuple[np.ndarray, int]:
    """Read a NIST SPHERE (.wav in TIMIT) file -> (int16 samples, sample_rate).

    Supports the uncompressed PCM encoding TIMIT ships. A RIFF fallback covers
    corpora re-encoded as standard wav.
    """
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic.startswith(b"RIFF"):
            return _read_riff(path)
        if not magic.startswith(b"NIST_1A"):
            raise ValueError(f"{path}: not a NIST SPHERE or RIFF file")
        header_size = int(f.read(8).strip())
        f.seek(0)
        header = f.read(header_size).decode("ascii", errors="replace")
        fields = {}
        for line in header.splitlines()[2:]:
            parts = line.strip().split(" ", 2)
            if len(parts) == 3:
                name, typ, val = parts
                if typ.startswith("-i"):
                    fields[name] = int(val)
                elif typ.startswith("-s"):
                    fields[name] = val
        n = fields.get("sample_count")
        rate = fields.get("sample_rate", 16000)
        enc = fields.get("sample_coding", "pcm")
        if "ulaw" in str(enc):
            raise NotImplementedError(f"{path}: ulaw SPHERE not supported")
        f.seek(header_size)
        data = np.frombuffer(f.read(), dtype="<i2")
        if fields.get("sample_byte_format") == "10":
            data = data.byteswap()
        if n is not None:
            data = data[:n]
        return data.astype(np.int16), rate


def _read_riff(path: str) -> tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        riff, _, wave = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        rate, data = 16000, None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = struct.unpack("<4sI", hdr)
            if cid == b"fmt ":
                fmt = f.read(size)
                rate = struct.unpack("<I", fmt[4:8])[0]
            elif cid == b"data":
                data = np.frombuffer(f.read(size), dtype="<i2")
            else:
                f.seek(size, 1)
        if data is None:
            raise ValueError(f"{path}: no data chunk")
        return data.astype(np.int16), rate


def write_riff(path: str, samples: np.ndarray, rate: int = 16000) -> None:
    """Write int16 mono PCM as a standard RIFF wav (``_read_riff``'s inverse)."""
    data = np.asarray(samples, "<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, rate, rate * 2, 2, 16))
        f.write(b"data" + struct.pack("<I", len(data)) + data)


def read_phn(path: str) -> list[str]:
    """Read a TIMIT .phn transcript -> list of phone symbols."""
    phones = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 3:
                phones.append(parts[2].lower())
    return phones


@dataclass
class TimitUtterance:
    wav_path: str
    phn_path: str
    speaker: str
    split: str  # train | dev | core_test | full_test


class TimitDataset:
    """The utterances of one TIMIT split, sorted by path.

    Splits: ``train`` (without the SA sentences), ``dev`` (the 50 standard
    dev speakers, or every non-core test speaker when none of them is
    present), ``core_test`` and ``full_test``.
    """

    def __init__(self, root: str, split: str = "train"):
        if not os.path.isdir(root):
            raise FileNotFoundError(
                f"TIMIT root {root!r} not found — this container has no TIMIT "
                "audio; use dataset='synthetic' (see SURVEY.md §7)."
            )
        self.root = root
        self.split = split
        self.utterances = self._index(split)
        if not self.utterances:
            raise FileNotFoundError(f"no TIMIT utterances under {root!r} for {split!r}")

    def _index(self, split: str) -> list[TimitUtterance]:
        utts = self._index_with(split, standard_dev=True)
        if split == "dev" and not utts:
            utts = self._index_with(split, standard_dev=False)
        return utts

    def _index_with(self, split: str, *, standard_dev: bool) -> list[TimitUtterance]:
        top = "train" if split == "train" else "test"
        utts = []
        for dirpath, _, files in os.walk(self.root):
            for fn in files:
                if not fn.lower().endswith(".wav"):
                    continue
                base = fn[:-4]
                if base.lower().startswith("sa"):
                    continue  # SA sentences excluded
                phn = next((c for ext in (".phn", ".PHN")
                            if os.path.exists(c := os.path.join(dirpath, base + ext))), None)
                if phn is None:
                    continue
                rel = os.path.relpath(dirpath, self.root).lower().split(os.sep)
                if top not in rel:
                    continue
                speaker = os.path.basename(dirpath).lower()
                is_core = speaker in CORE_TEST_SPEAKERS
                wav = os.path.join(dirpath, fn)
                if split == "train" and top == "train":
                    utts.append(TimitUtterance(wav, phn, speaker, "train"))
                elif split == "core_test" and is_core:
                    utts.append(TimitUtterance(wav, phn, speaker, "core_test"))
                elif split == "full_test" and top == "test":
                    utts.append(TimitUtterance(wav, phn, speaker, "full_test"))
                elif split == "dev" and top == "test":
                    if speaker in DEV_SPEAKERS if standard_dev else not is_core:
                        utts.append(TimitUtterance(wav, phn, speaker, "dev"))
        return sorted(utts, key=lambda u: u.wav_path)

    def __len__(self):
        return len(self.utterances)

    def load(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """-> (float32 waveform in [-1, 1], int32 phone ids)."""
        utt = self.utterances[i]
        samples, _ = read_sphere(utt.wav_path)
        phones = read_phn(utt.phn_path)
        ids = np.array([PHONE_TO_ID[p] for p in phones if p in PHONE_TO_ID], np.int32)
        return samples.astype(np.float32) / 32768.0, ids
