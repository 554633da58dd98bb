"""User-facing inference: weights -> transcriptions (counterpart of
``qasr/infer.py``).

    from qasr_torch.infer import Transcriber
    t = Transcriber("/path/to/export", device="cuda", beam=True)
    phones = t.transcribe_file("sx42.wav")            # ['h#', 'sh', ...]
    folded = t.transcribe_file("sx42.wav", fold=True) # 39-phone protocol

A checkpoint directory for the port holds ``config.json`` (the ``Config``
JSON that either package's training writes) and ``params.npz`` (see
``qasr_torch.bridge``). Features, the encoder and the decoding run on
``device`` (the GPU unless the caller asks for the CPU): greedy best-path, or
with ``beam=True`` the prefix beam search (``qasr_torch.decode.beam``) at the
config's width and pruning.
"""

from __future__ import annotations

import os
from collections.abc import Mapping

import numpy as np
import torch

from qasr_torch.configs import Config
from qasr_torch.bridge import load_params_npz, params_from_jax
from qasr_torch.data.librispeech import ids_to_text
from qasr_torch.data.timit import ID_TO_PHONE, fold_to_39, read_sphere
from qasr_torch.decode.beam import ctc_beam_search_decode
from qasr_torch.features.frontend import FrontendConfig, featurize_waveform
from qasr_torch.models import build_model
from qasr_torch.native import flac_decode_native, flac_probe
from qasr_torch.ops.ctc import ctc_greedy_decode
from qasr_torch.utils.profiling import span


def _next_time_pad(t: int, bucket_sizes: tuple[int, ...]) -> int:
    """Bucketed time padding, as training batches are padded."""
    for b in bucket_sizes:
        if t <= b:
            return b
    p = max(bucket_sizes) if bucket_sizes else 1
    while p < t:
        p *= 2
    return p


class Transcriber:
    """Transcribe waveforms and audio files with a qcnn or qlstm model.

    Args:
      checkpoint_dir: directory with ``config.json`` and ``params.npz``.
      cfg: the config, instead of (or overriding) ``config.json``.
      params: weights as a state_dict or a nested JAX-style tree of arrays,
        instead of ``params.npz``.
      beam: prefix beam search (``cfg.decode.beam_width``,
        ``cfg.decode.beam_prune_logp``) instead of greedy best-path.
      device: where features, the encoder and the decoding run (the GPU
        unless the caller asks for the CPU; no fallback when there is none).
    """

    def __init__(
        self,
        checkpoint_dir: str | None = None,
        *,
        cfg: Config | None = None,
        params: Mapping | None = None,
        beam: bool = False,
        device: torch.device | str = "cuda",
    ):
        if cfg is None:
            if checkpoint_dir is None:
                raise ValueError("pass checkpoint_dir or cfg")
            cfg_path = os.path.join(checkpoint_dir, "config.json")
            if not os.path.exists(cfg_path):
                raise FileNotFoundError(f"no config.json in {checkpoint_dir!r}; pass cfg=")
            with open(cfg_path) as f:
                cfg = Config.from_json(f.read())
        if params is None:
            if checkpoint_dir is None:
                raise ValueError("pass checkpoint_dir or params")
            params = load_params_npz(os.path.join(checkpoint_dir, "params.npz"))
        elif any(isinstance(v, Mapping) for v in params.values()):
            params = params_from_jax(params)
        self.cfg = cfg
        self.beam = beam
        self.device = torch.device(device)
        self.fcfg = FrontendConfig(sample_rate=cfg.data.sample_rate, n_mels=cfg.data.n_mels)
        self.model = build_model(cfg, device=self.device)
        self.model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})

    # -- forward -------------------------------------------------------------

    @torch.no_grad()
    def logits(self, wavs, *, plain: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """Waveforms -> (logits ``[B, T_pad, V]`` f32, lengths ``[B]``) on the
        device; utterances pad to the bucket of the longest, and the encoder
        gets their frame counts (a QLSTM freezes its state on the padding).
        ``plain=True`` runs every kernel's plain PyTorch version (the
        reference path)."""
        with span("qasr.frontend"):
            feats = [featurize_waveform(w, self.fcfg, device=self.device) for w in wavs]
            lengths = torch.tensor([f.shape[0] for f in feats], device=self.device)
            t_pad = _next_time_pad(int(lengths.max()), self.cfg.data.bucket_sizes)
            batch = torch.zeros(
                (len(feats), t_pad, self.cfg.data.n_mels, 4), device=self.device
            )
            for i, f in enumerate(feats):
                batch[i, : f.shape[0]] = f
        with span("qasr.forward"):
            return self.model(batch, lengths=lengths, plain=plain), lengths

    def decode(self, logits: torch.Tensor, lengths: torch.Tensor):
        """Logits -> (sequences ``[B, L]`` padded with -1, lengths ``[B]``) as
        numpy arrays, decoded on the logits' device."""
        with span("qasr.decode"):
            if self.beam:
                # max_len = the padded frame count: CTC emits at most one symbol
                # a frame, so nothing truncates (cfg.data.max_label_len bounds
                # the training labels, not a transcription)
                seq, lens, _ = ctc_beam_search_decode(
                    logits,
                    lengths,
                    beam_width=self.cfg.decode.beam_width,
                    blank_id=self.cfg.decode.blank_id,
                    max_len=int(logits.shape[1]),
                    prune_logp=self.cfg.decode.beam_prune_logp,
                )
            else:
                seq, lens = ctc_greedy_decode(logits, lengths, blank_id=self.cfg.decode.blank_id)
            return seq.cpu().numpy(), lens.cpu().numpy()

    # -- symbol mapping ------------------------------------------------------

    def ids_to_symbols(self, ids, *, fold: bool = False):
        """Decoded ids -> TIMIT phone strings (optionally folded to the 39-phone
        scoring set) or LibriSpeech characters (joined string)."""
        ids = [int(i) for i in ids]
        if self.cfg.data.dataset == "librispeech":
            if fold:
                raise ValueError("fold=True is the TIMIT 61->39 phone fold")
            return ids_to_text(ids)
        phones = [ID_TO_PHONE[i] for i in ids if i in ID_TO_PHONE]
        return fold_to_39(phones) if fold else phones

    # -- public entry points -------------------------------------------------

    def transcribe_batch(self, wavs, *, fold: bool = False):
        """Transcribe a list of ``[N]`` float32 waveforms in one batch."""
        with span("qasr.transcribe"):
            seq, lens = self.decode(*self.logits(wavs))
            return [self.ids_to_symbols(seq[i][: int(lens[i])], fold=fold)
                    for i in range(len(wavs))]

    def transcribe(self, wav, *, fold: bool = False):
        """Transcribe one ``[N]`` float32 waveform at cfg.data.sample_rate."""
        return self.transcribe_batch([wav], fold=fold)[0]

    def transcribe_file(self, path: str, *, fold: bool = False):
        """Transcribe one audio file (NIST SPHERE / RIFF wav / FLAC)."""
        if path.lower().endswith(".flac"):
            samples, rate = flac_decode_native(path)
            samples = samples[:, 0]  # [n, channels] -> mono
            scale = float(2 ** (flac_probe(path)["bps"] - 1))
        else:
            samples, rate = read_sphere(path)
            scale = 32768.0  # SPHERE/RIFF path is 16-bit PCM
        if rate != self.cfg.data.sample_rate:
            raise ValueError(
                f"{path!r} is {rate} Hz but the model expects "
                f"{self.cfg.data.sample_rate} Hz (no resampler in qasr)"
            )
        return self.transcribe(samples.astype(np.float32) / scale, fold=fold)
