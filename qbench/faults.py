"""Faults planted in the timed path, to show that ``correct`` catches them:
each a context manager that patches the program for its duration. Used by
the fault tests (on the CPU, at tiny sizes) and by ``calibrate.py`` (on the
card, at the cells' sizes), never by a benchmark run.

Training: ``stale_state`` (a step returns its state unchanged),
``half_batch`` (the loss over half of the batch, the mean over the rest),
``token`` (a token of each row altered where the model produces it: the
output layer's logits of each row's first frame rolled by one class).
Serving: ``half_batch`` (half of the utterances' features left out),
``token`` (a decoded token altered where the decoder produces it).
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = {"train": ("stale_state", "half_batch", "token"), "serve": ("half_batch", "token")}


@contextlib.contextmanager
def _patched(module, name, value):
    orig = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, orig)


def planted(kind: str, fault: str):
    """The patch of ``fault`` for a ``kind`` ("train" or "serve") run."""
    if fault not in FAULTS[kind]:
        raise ValueError(f"no fault {fault!r} for {kind} (choose {' | '.join(FAULTS[kind])})")
    if kind == "train":
        import qasr_torch.train.step as step

        if fault == "stale_state":
            def apply_gradients(state):
                state.step += 1
                return step.global_norm([p.grad for p in state.model.parameters()])
            return _patched(step, "apply_gradients", apply_gradients)
        if fault == "half_batch":
            orig = step.loss_fn

            def loss_fn(cfg, logits, batch, tokens=None):
                half = logits.shape[0] // 2
                return orig(cfg, logits[:half], {k: v[:half] for k, v in batch.items()}, tokens)
            return _patched(step, "loss_fn", loss_fn)
        import qasr_torch.models.layers as layers

        dense = layers.Dense.forward

        def forward(self, x):
            y = dense(self, x)
            return torch.cat([y[:, :1].roll(1, dims=-1), y[:, 1:]], dim=1)
        return _patched(layers.Dense, "forward", forward)

    import qasr_torch.infer as infer

    if fault == "half_batch":
        orig_feat = infer.featurize_waveform
        calls = [0]

        def featurize_waveform(wav, cfg, *, device):
            calls[0] += 1
            f = orig_feat(wav, cfg, device=device)
            return f if calls[0] % 2 else f * 0
        return _patched(infer, "featurize_waveform", featurize_waveform)
    orig_dec = infer.ctc_greedy_decode

    def ctc_greedy_decode(logits, lengths, *, blank_id=0):
        seq, lens = orig_dec(logits, lengths, blank_id=blank_id)
        seq, lens = seq.clone(), lens.clone()
        seq[0, 0] = seq[0, 0] % (logits.shape[-1] - 1) + 1
        lens[0] = lens[0].clamp_min(1)
        return seq, lens
    return _patched(infer, "ctc_greedy_decode", ctc_greedy_decode)
