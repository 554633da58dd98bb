"""TIMIT phone inventory, the 61->39 fold and the SPHERE/RIFF reader (the
port's own copy of those parts of ``qasr/data/timit.py``; a test holds the
tables equal to the reference's).
"""

from __future__ import annotations

import struct

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
