"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port's serving path and its training path (``qasr_torch``, no
JAX) at the full width of ``timit_qcnn`` (the paper's QCNN-256, bf16
compute, random weights from a seeded ``torch.Generator``), and the serving
and training paths of ``librispeech_qlstm``, through the hand-written CUDA
kernels, and checks them. Phases, one line each (or a few):

  1. device   the card's name and power limit (nvidia-smi)
  2. build    nvcc build of qasr_torch/csrc/*.cu into qasr_torch/_build/
  3. parity   each kernel (A: the conv, B: the GEMM and its dx role, C: the
              transposed conv with the PReLU backward) against its plain
              PyTorch version on the card, at the paths' shapes, f32
              (tight) and bf16 (loose), gated
  4. serving  a Transcriber on four synthetic 1-3 s waveforms, greedy and
              beam; kernel launch counts per forward; kernel-path logits
              against the plain path's, gated
  5. timing   encoder forward and train step at B16 x T256, and each kernel
              at its path shape, against its plain version and one library
              call (CUDA events; not gated)
  6. train    gradient parity of one train step, kernel path against plain
              path (bf16 and f32); launches per step; twenty steps on one
              batch lower the loss; one ``train()`` call with an eval and a
              checkpoint that a Transcriber then serves; gated
  7. qlstm    ``librispeech_qlstm`` (config 4: the QCNN-biQLSTM, H=256, bf16)
              at full width: kernel D (the QLSTM recurrence) against its
              plain version at B32 x T512 with ragged lengths, and kernels A
              and B at the shapes of the serving run below against theirs
              (f32 and bf16, gated); a Transcriber on four synthetic 2-5 s waveforms,
              greedy and beam, with its launches per forward and its logits
              gated; then, not gated, the encoder forward at B32 x T512
              (with a torch.profiler breakdown of one forward), kernel D
              against its plain version and one cuDNN LSTM layer, and both
              input-projection arms at M = 16384
  8. qlstm    config 4's training at full width: kernel E (the recurrence's
     train    backward) against its plain version at B32 x T512 with ragged
              lengths, twice for the same bits, kernels A and C at the
              tower's three stacked shapes and kernel B (forward and dx) at
              qdense_0's M = 16384 (f32 and bf16, gated); gradient parity of
              one train step, kernel path against plain path (bf16 and f32);
              launches per step; twenty steps on one batch lower the loss;
              one ``train()`` call whose checkpoint a Transcriber serves
              (gated); then, not gated, the train step kernel and plain
              (with a torch.profiler breakdown), kernel E against its plain
              version, its bound and the dW einsums, one QBiLSTM layer
              forward + backward against one cuDNN LSTM's, and both
              input-projection arms at M 2048-16384

then one JSON line with the per-kernel results, the nvidia-smi line and,
last, the device line ``{"ok": true, "device": {...}}``. Any failure raises:
the script then exits non-zero and prints no result line. It fails without
a CUDA device.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
# f32 runs the kernels' CUDA-core path: only the summation order differs
# from the plain version (cuDNN / cuBLAS in full f32, TF32 off).
TOL_F32 = {"rel_norm": 2e-5, "max_rel": 2e-4}
# bf16 rounds the input combos (V8 x) and the weight combos (U8 w) to an
# 8-bit mantissa (unit roundoff 2^-9 ~ 2e-3 each) before the f32-accumulated
# products: ~4e-3 relative per output, held against the f32 plain version
# on the same bf16 inputs. Kernel C's dalpha sums g * z_prev of such outputs
# in f32: the same relative error.
TOL_BF16 = {"rel_norm": 1e-2, "max_rel": 5e-2}
# Serving logits in bf16 end to end, against the plain path in f32 on the
# same weights: each of the 13 layer boundaries rounds to bf16 (~4e-3 each,
# growing roughly as sqrt(13): ~1.4e-2). Kernel path against the bf16 plain
# path: two such paths rounding at different places, ~sqrt(2) more.
TOL_LOGITS_F32 = {"rel_norm": 3e-2, "max_rel": 1e-1}
TOL_LOGITS = {"rel_norm": 5e-2, "max_rel": 1e-1}
# One train step's gradients, kernel path against plain path on the same
# weights and batch. Two sources of difference. (a) Rounding: in bf16 the
# forward rounds at 13 layer boundaries and the backward at 13 more, ~4e-3
# each, at different places on the two paths: ~sqrt(2 * 26) * 4e-3 ~ 3e-2.
# (b) The PReLU kink: a pre-activation within the forward error d of zero
# takes the other slope on one path; a fraction ~0.8 d / sigma of the
# elements does, so a layer's gradient moves by ~0.75 sqrt(0.8 d / sigma)
# relative: ~4e-2 a layer in bf16 (d / sigma ~ 4e-3), and the deepest
# gradients gather it from every layer above. Limit 1.5e-1 on each
# parameter's gradient. The loss is a mean over 4096 frames whose
# per-frame errors largely cancel: 1e-2.
TOL_GRAD_BF16 = {"rel_norm": 1.5e-1}
TOL_LOSS_BF16 = 1e-2
# In f32 the kink alone would give ~0.75 sqrt(0.8e-6) ~ 7e-4 a layer, so the
# f32 check sets every PReLU slope to 1 (no kink) and holds the arithmetic:
# every kernel sums in f32 in another order (~1e-6 a layer), compounding
# over 26 layers to ~1e-5; limit 1e-4.
TOL_GRAD_F32 = {"rel_norm": 1e-4}
TOL_LOSS_F32 = 1e-4

# H100 SXM datasheet peaks, the bounds' denominators (dense bf16, HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12
FRAME_S = 0.010  # 10 ms hop: one frame is 10 ms of audio


def _line(**kw) -> None:
    print(json.dumps(kw), flush=True)


def _errors(got: torch.Tensor, ref: torch.Tensor) -> dict:
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise RuntimeError("non-finite output")
    diff = (got - ref).abs()
    scale = ref.abs().max().item()
    return {
        "max_abs_err": diff.max().item(),
        "max_rel": diff.max().item() / max(scale, 1e-30),
        "rel_norm": ((got - ref).norm() / ref.norm().clamp_min(1e-30)).item(),
    }


def _gate(name: str, err: dict, tol: dict) -> None:
    for k, lim in tol.items():
        if not err[k] <= lim:
            raise RuntimeError(f"{name}: {k}={err[k]:.3e} exceeds {lim:.1e}")


def _report(name: str, err: dict, tol: dict, phase: int = 3) -> None:
    _gate(name, err, tol)
    print(f"phase {phase} parity {name}: max_abs {err['max_abs_err']:.3e} "
          f"max_rel {err['max_rel']:.3e} rel_norm {err['rel_norm']:.3e} (tol {tol})",
          flush=True)


def _time_ms(fn, n: int, warm: int = 2) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def _alternating(kernel_fn, plain_fn, n: int, n_plain: int | None = None,
                 warm: int = 2) -> tuple[float, float]:
    """plain, kernel, kernel, plain; the mean of each pair (the plain runs
    ``n_plain`` times each, default ``n``)."""
    n_plain = n if n_plain is None else n_plain
    p1 = _time_ms(plain_fn, n_plain, warm)
    k1 = _time_ms(kernel_fn, n, warm)
    k2 = _time_ms(kernel_fn, n, warm)
    p2 = _time_ms(plain_fn, n_plain, warm)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take, in ms: the larger of the
    operations over the bf16 tensor-core peak and the bytes (each input read
    once, each output written once) over the HBM rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _counters():
    from qasr_torch.ops.kernels.qconv_dx8 import qconv_dx8
    from qasr_torch.ops.kernels.qconv_ft import qconv_ft8
    from qasr_torch.ops.kernels.qgemm8 import qgemm8_cl, qgemm8_dx
    from qasr_torch.ops.kernels.qlstm_scan import qlstm_scan_bwd, qlstm_scan_fast8

    return {"qconv_ft8": qconv_ft8, "qgemm8": qgemm8_cl, "qgemm8_dx": qgemm8_dx,
            "qconv_dx8": qconv_dx8, "qlstm_scan8": qlstm_scan_fast8,
            "qlstm_scan8_bwd": qlstm_scan_bwd}


def _reset_counts() -> None:
    torch.cuda.synchronize()
    for fn in _counters().values():
        fn.launches = 0


def _read_counts() -> dict:
    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in _counters().items()}


def _cudnn_lstm(layer, dtype) -> torch.nn.LSTM:
    """One ``nn.LSTM`` (bidirectional, hidden 4H real units) computing the
    QBiLSTM ``layer``: its weights are the Hamilton-expanded quaternion
    ones, the gate rows taken from the packed lanes ``[q, g, H]`` in cuDNN's
    order i, f, g, o (the port's gate groups are i, f, o, g), the hidden
    unit ``q*H + j`` being the port's component-major lane."""
    from qasr_torch.ops.quaternion import hamilton_expand

    hid, cin = layer.hidden, layer.fwd_cell.wx.shape[1]
    dev = layer.fwd_cell.wx.device
    lstm = torch.nn.LSTM(4 * cin, 4 * hid, batch_first=True, bidirectional=True, device=dev)
    gate = torch.tensor([0, 1, 3, 2], device=dev).view(4, 1, 1)
    comp = torch.arange(4, device=dev).view(1, 4, 1)
    unit = torch.arange(hid, device=dev).view(1, 1, hid)
    idx = (comp * 4 * hid + gate * hid + unit).reshape(-1)  # [cuDNN gate, q, j]
    with torch.no_grad():
        for sfx, cell in (("", layer.fwd_cell), ("_reverse", layer.bwd_cell)):
            getattr(lstm, f"weight_ih_l0{sfx}").copy_(hamilton_expand(cell.wx)[:, idx].T)
            getattr(lstm, f"weight_hh_l0{sfx}").copy_(hamilton_expand(cell.wh)[:, idx].T)
            getattr(lstm, f"bias_ih_l0{sfx}").copy_(cell.bias[idx])
            getattr(lstm, f"bias_hh_l0{sfx}").zero_()
    lstm = lstm.to(dtype)
    lstm.flatten_parameters()  # one weight buffer, as cuDNN wants it: no compaction a call
    return lstm


def _grad_parity(tcfg, batch: dict, dev: torch.device, phase: int, what: str = "") -> None:
    """One train step's gradients and loss, kernel path against plain path
    on the same weights and batch, dropout off: bf16 with the slopes as
    drawn and f32 with every PReLU slope 1 (no kink), each parameter's
    gradient and the loss gated (the error model is beside TOL_GRAD_BF16)."""
    from qasr_torch.models.layers import PReLU
    from qasr_torch.train.state import create_train_state
    from qasr_torch.train.step import batch_to_device, loss_fn

    def grads(cfg_, plain, unit_slopes):
        st = create_train_state(cfg_, device=dev)
        if unit_slopes:
            with torch.no_grad():
                for m in st.model.modules():
                    if isinstance(m, PReLU):
                        m.alpha.fill_(1.0)
        b = batch_to_device(batch, dev)
        logits = st.model(b["features"], lengths=b["feature_lengths"], plain=plain,
                          generator=st.generator)
        loss = loss_fn(cfg_, logits, b)
        loss.backward()
        return loss.detach().float(), {k: p.grad.float() for k, p in st.model.named_parameters()}

    for dtype, tol, tol_loss, unit in (("bfloat16", TOL_GRAD_BF16, TOL_LOSS_BF16, False),
                                       ("float32", TOL_GRAD_F32, TOL_LOSS_F32, True)):
        pcfg = tcfg.override(**{"model.dropout_rate": 0.0, "model.compute_dtype": dtype})
        loss_k, g_k = grads(pcfg, False, unit)
        loss_p, g_p = grads(pcfg, True, unit)
        torch.cuda.synchronize()
        dl = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
        if not (math.isfinite(loss_k.item()) and dl <= tol_loss):
            raise RuntimeError(f"{what}train loss {dtype}: kernel {loss_k.item()} plain "
                               f"{loss_p.item()} (rel {dl:.3e} > {tol_loss:.1e})")
        worst = ("", 0.0)
        for k in g_p:
            err = _errors(g_k[k], g_p[k])
            _gate(f"{what}train grad {dtype} {k}", err, tol)
            worst = max(worst, (k, err["rel_norm"]), key=lambda v: v[1])
        print(f"phase {phase} train parity {dtype}{' (PReLU slopes 1)' if unit else ''}: "
              f"{what}loss kernel {loss_k.item():.6f} plain {loss_p.item():.6f} (rel {dl:.3e}, "
              f"tol {tol_loss:.0e}); {len(g_p)} gradients, worst rel_norm {worst[1]:.3e} "
              f"({worst[0]}) (tol {tol})", flush=True)
        del g_k, g_p
        torch.cuda.empty_cache()


def _train_and_serve(lcfg, dev: torch.device, name: str, wavs: list, per_step: dict):
    """The main path of a training slice: one ``train()`` call (its steps,
    an eval over the synthetic set, a checkpoint under
    ``qasr_torch/_build/<name>``) and a Transcriber serving that checkpoint.
    Gated: the steps taken, a finite loss, the eval, ``per_step`` launches a
    step of each kernel named there, finite served logits and the served
    params equal to the trained ones. Returns the last log, the launches,
    the hypotheses and the seconds ``train()`` took."""
    from qasr_torch.infer import Transcriber
    from qasr_torch.train.loop import train

    ckpt_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "qasr_torch",
                             "_build", name)
    shutil.rmtree(ckpt_root, ignore_errors=True)
    n = lcfg.train.num_steps
    _reset_counts()
    t0 = time.perf_counter()
    lstate, last = train(lcfg, device=dev, checkpoint_dir=ckpt_root)
    train_s = time.perf_counter() - t0
    counts = _read_counts()
    if lstate.step != n or not math.isfinite(last["loss"]) or "dev_per" not in last:
        raise RuntimeError(f"{name}: train() ended at step {lstate.step} with {last}")
    if any(counts[k] != v * n for k, v in per_step.items()):
        raise RuntimeError(f"{name}: train() launches {counts}, expected {per_step} a step")
    served = Transcriber(last["checkpoint"], device=dev)
    hyp = served.transcribe_batch(wavs)
    ck_logits, _ = served.logits(wavs)
    if not torch.isfinite(ck_logits).all() or len(hyp) != len(wavs):
        raise RuntimeError(f"{name}: the trained checkpoint did not serve")
    sd = lstate.model.state_dict()
    for k, v in served.model.state_dict().items():
        if not torch.equal(v, sd[k]):
            raise RuntimeError(f"{name}: checkpoint param {k} differs from the trained one")
    del lstate, served
    shutil.rmtree(ckpt_root, ignore_errors=True)
    torch.cuda.empty_cache()
    return last, counts, hyp, train_s


def phase7_qlstm(dev: torch.device, smi: str) -> dict:
    """Config 4 serving at full width; returns kernel D's entry of the
    kernels line."""
    from qasr_torch.configs import get_config
    from qasr_torch.infer import Transcriber
    from qasr_torch.models import build_model
    from qasr_torch.models.qlstm import QBiLSTM, input_proj_fn
    from qasr_torch.ops.initializers import quaternion_init
    from qasr_torch.ops.kernels.qconv_ft import qconv_fast8_stacked_plain, qconv_ft8
    from qasr_torch.ops.kernels.qgemm8 import qdense_pallas8, qgemm8_cl, qgemm8_cl_plain
    from qasr_torch.ops.kernels.qlstm_scan import qlstm_scan_fwd, qlstm_scan_fwd_plain
    from qasr_torch.ops.quaternion import combine_weights

    g = torch.Generator(device=dev).manual_seed(SEED + 7)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    bf16 = torch.bfloat16
    cfg = get_config("librispeech_qlstm")
    # the preset's batch, its first bucket and its hidden size: B32 x T512, H256
    T, B, H = cfg.data.bucket_sizes[0], cfg.data.batch_size, cfg.model.lstm_features
    # kernel D against its plain version at the path's shape, both
    # directions, ragged lengths; hs, cs and gates all gated.
    # f32: the products sum in another order (~1e-7 a step) and the
    # recurrence, its forget gates below 1, damps what was carried: TOL_F32.
    # bf16: both versions carry h and c in bf16, rounded every step at the
    # same places, so they differ where a value rounds to the other
    # neighbouring bf16 number (2^-8 relative), now and then, and that too
    # is damped (tests/test_torch_qlstm.py holds the plain version so
    # against _fwd_xla on the CPU): TOL_BF16.
    lens = torch.randint(T // 4, T + 1, (B,), generator=g, device=dev)
    lens[0] = T
    xz32 = rnd(T, 2, B, 16 * H, scale=0.5)
    wc32 = torch.stack([
        combine_weights(quaternion_init((4, H, 4 * H), generator=torch.Generator().manual_seed(
            SEED + d), device=dev)) for d in range(2)])
    max_err = 0.0
    for dtype, tol in ((torch.float32, TOL_F32), (bf16, TOL_BF16)):
        xz, wc = xz32.to(dtype), wc32.to(dtype)
        got = qlstm_scan_fwd(xz, wc, lens)
        want = qlstm_scan_fwd_plain(xz, wc, lens)
        dname = str(dtype)[6:]
        for name, a, b in zip(("hs", "cs", "gates"), got, want):
            err = _errors(a, b)
            _report(f"qlstm_scan8 T{T} B{B} H{H} D2 ragged {name} {dname}", err, tol, 7)
            if dtype == bf16:
                max_err = max(max_err, err["max_abs_err"])
        if dtype == bf16:
            again = qlstm_scan_fwd(xz, wc, lens)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise RuntimeError("qlstm_scan8 differs between two runs on the same inputs")
        del got, want, xz

    # kernels A and B at the shapes the serving run below gives them (four
    # utterances in the 512 bucket, F = 40 mels pooled by 3 = 13), against
    # their plain versions, gated as in phase 3. A: the tower's three stacked
    # layers, each with the previous layer's PReLU as prologue and its bias.
    # B at M = 4 x 512: the input projections (N = 2 directions x 4H; K = F x
    # the tower's last width for layer 0, 2H after) and qdense_0 (K = 2H).
    nb, nf, conv = 4, 13, cfg.model.conv_features
    gemms = ((nb * T, nf * conv[-1], 8 * H), (nb * T, 2 * H, 8 * H),
             (nb * T, 2 * H, cfg.model.dense_features[0]))
    for dtype, tol in ((torch.float32, TOL_F32), (bf16, TOL_BF16)):
        dname = str(dtype)[6:]
        for cin, cout in zip(conv[:-1], conv[1:]):
            w = rnd(4, 3, 3, cin, cout, scale=(1.0 / (9 * cin)) ** 0.5)
            bias, alpha = rnd(4 * cout, scale=0.1), rnd(4 * cin, scale=0.25).abs()
            x = rnd(nb, 4, nf, T, cin, scale=0.5).to(dtype)
            err = _errors(qconv_ft8(x, w, bias, alpha),
                          qconv_fast8_stacked_plain(x.float(), w, bias, alpha))
            _report(f"qconv_ft8 B{nb} F{nf} T{T} C{cin}->{cout} k3x3 {dname} prologue+bias",
                    err, tol, 7)
        for m, k, n in gemms:
            w = rnd(4, k, n, scale=(1.0 / k) ** 0.5)
            x4 = rnd(4, m, k, scale=0.5).to(dtype)
            err = _errors(qgemm8_cl(x4, w), qgemm8_cl_plain(x4.float(), w))
            _report(f"qgemm8 M{m} K{k} N{n} {dname}", err, tol, 7)
    del x, x4, w
    torch.cuda.empty_cache()

    # the serving path: build_model, then a Transcriber, greedy and beam
    model = build_model(cfg, generator=torch.Generator().manual_seed(SEED), device=dev)
    if model.recurrent != "pallas8" or sum(model.stacked) != 3 or model.lstm_layers != 3:
        raise RuntimeError(f"config 4 routing: recurrent {model.recurrent}, stacked "
                           f"{model.stacked}, {model.lstm_layers} layers")
    params = model.state_dict()
    del model
    greedy = Transcriber(cfg=cfg, params=params, device=dev)
    beam = Transcriber(cfg=cfg, params=params, device=dev, beam=True)
    rng = np.random.default_rng(SEED + 7)
    wavs = []
    for n_s in rng.uniform(2.0, 5.0, size=4):
        n = int(n_s * cfg.data.sample_rate)
        env = np.abs(np.sin(np.linspace(0, 10 * np.pi, n)))
        wavs.append((0.1 * env * rng.standard_normal(n)).astype(np.float32))
    _reset_counts()
    hyp_greedy = greedy.transcribe_batch(wavs)
    hyp_beam = beam.transcribe_batch(wavs)
    counts = _read_counts()
    enc = greedy.model
    logits, lengths = greedy.logits(wavs)
    logits_plain, _ = greedy.logits(wavs, plain=True)
    rows = len(wavs) * logits.shape[1]
    n_b = enc.n_dense + sum(
        input_proj_fn(getattr(enc, f"qbilstm_{i}").input_proj, rows) is qdense_pallas8
        for i in range(enc.lstm_layers))
    want = {"qconv_ft8": 2 * 3, "qgemm8": 2 * n_b, "qgemm8_dx": 0, "qconv_dx8": 0,
            "qlstm_scan8": 2 * 3, "qlstm_scan8_bwd": 0}  # two forwards
    if counts != want:
        raise RuntimeError(f"config 4 serving launches {counts}, expected {want}")
    if not all(isinstance(h, str) for h in hyp_greedy + hyp_beam):
        raise RuntimeError("config 4 serving did not return character strings")
    want_shape = (4, T, cfg.model.vocab)
    if tuple(logits.shape) != want_shape:
        raise RuntimeError(f"logits shape {tuple(logits.shape)}, expected {want_shape}")
    # Logits in bf16 against the f32 plain path on the same weights: bf16
    # rounds at the four conv layers, the three input projections, the
    # recurrences' carried state (damped, as above), the dense and the
    # output layer, ~4e-3 each: ~1.3e-2 in all. The two bf16 paths round at
    # the same places: only their sums differ in order. Same limits as the
    # QCNN's.
    cfg32 = cfg.override(**{"model.compute_dtype": "float32"})
    logits_f32, _ = Transcriber(cfg=cfg32, params=params, device=dev).logits(wavs, plain=True)
    torch.cuda.synchronize()
    lerr = _errors(logits, logits_plain)
    _gate("config 4 logits kernel vs plain", lerr, TOL_LOGITS)
    kerr32 = _errors(logits, logits_f32)
    _gate("config 4 logits kernel vs f32 plain", kerr32, TOL_LOGITS_F32)
    perr32 = _errors(logits_plain, logits_f32)
    _gate("config 4 logits plain bf16 vs f32 plain", perr32, TOL_LOGITS_F32)
    print(f"phase 7 serving: librispeech_qlstm bf16, {len(wavs)} utterances "
          f"({', '.join(f'{len(w) / cfg.data.sample_rate:.2f}' for w in wavs)} s, frames "
          f"{lengths.tolist()}), logits {tuple(logits.shape)} finite; launches per forward "
          f"qlstm_scan8 {counts['qlstm_scan8'] // 2} qconv_ft8 {counts['qconv_ft8'] // 2} "
          f"qgemm8 {counts['qgemm8'] // 2} (input projections at M={rows} on "
          f"{'kernel B' if n_b > enc.n_dense else 'the block product'}); greedy characters "
          f"{[len(h) for h in hyp_greedy]}, beam (W={cfg.decode.beam_width}) characters "
          f"{[len(h) for h in hyp_beam]}; logits kernel vs plain max_abs "
          f"{lerr['max_abs_err']:.3e} rel_norm {lerr['rel_norm']:.3e} (tol {TOL_LOGITS}); "
          f"against the f32 plain path: kernel rel_norm {kerr32['rel_norm']:.3e}, bf16 plain "
          f"rel_norm {perr32['rel_norm']:.3e} (tol {TOL_LOGITS_F32})", flush=True)
    del beam, logits_plain, logits_f32

    # timing (not gated): B32 x T512, 163.84 s of audio
    audio_s = B * T * FRAME_S
    with torch.no_grad():
        feats = rnd(B, T, cfg.data.n_mels, 4)
        full = torch.full((B,), T, device=dev)
        fwd_k, fwd_p = _alternating(lambda: enc(feats, lengths=full),
                                    lambda: enc(feats, lengths=full, plain=True), 2)
        # where one kernel-path forward's device time goes (torch.profiler)
        cuda = torch.autograd.DeviceType.CUDA
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            enc(feats, lengths=full)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kern = [e for e in prof.key_averages() if e.device_type == cuda]
        busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
        top = sorted(kern, key=lambda e: e.self_device_time_total, reverse=True)[:8]
        xz, wc = xz32.to(bf16), wc32.to(bf16)
        del xz32
        d_k, d_p = _alternating(lambda: qlstm_scan_fwd(xz, wc), lambda: qlstm_scan_fwd_plain(xz, wc), 3)
        # xz and wc8 in; hs, cs (each [T, D, B, 4H]) and gates (as xz) out
        bound_d = _bound(2 * 8 * T * 2 * B * H * 4 * H,
                         2 * _nbytes(xz) + _nbytes(wc) + 2 * (_nbytes(xz) // 4))
        del xz
        # one whole QBiLSTM layer (layer 1's shape: 2H channels in) against
        # one cuDNN LSTM on the expanded weights, checked in f32 first
        layer = QBiLSTM(2 * H, H, recurrent="pallas8", device=dev,
                        generator=torch.Generator().manual_seed(SEED + 3))
        for cell in (layer.fwd_cell, layer.bwd_cell):
            cell.bias.copy_(rnd(16 * H, scale=0.1))
        xl = rnd(B, T, 4 * 2 * H, scale=0.5)
        ref = layer(xl, plain=True)  # f32, no lengths
        ref = ref.reshape(B, T, 4, 2, H).transpose(2, 3).reshape(B, T, 8 * H)
        lib = _cudnn_lstm(layer, torch.float32)(xl)[0]
        _gate("cuDNN LSTM yardstick (f32) vs the plain QBiLSTM", _errors(lib, ref),
              {"rel_norm": 1e-3})
        del lib, ref
        layer.dtype = bf16
        xl16 = xl.to(bf16)
        layer_ms = _time_ms(lambda: layer(xl16), 5)
        lstm_bf16 = _cudnn_lstm(layer, bf16)
        lib_bf16 = _time_ms(lambda: lstm_bf16(xl16), 5)
        lstm_fp16, xl_fp16 = _cudnn_lstm(layer, torch.float16), xl.to(torch.float16)
        lib_fp16 = _time_ms(lambda: lstm_fp16(xl_fp16), 5)
        cudnn_ok = (torch.backends.cudnn.is_acceptable(xl16),
                    torch.backends.cudnn.is_acceptable(xl_fp16))
        del lstm_bf16, lstm_fp16, xl, xl16, xl_fp16
        # the input projection's two arms at M = B*T, N = 2*4H, for layer 0
        # (K = F*C of the tower) and layers 1-2 (K = 2H)
        arms = {}
        for k in (enc.qbilstm_0.fwd_cell.wx.shape[1], 2 * H):
            xp = rnd(B * T, 4 * k, scale=0.5).to(bf16)
            wp = rnd(4, k, 8 * H, scale=k ** -0.5)
            r8, blk = input_proj_fn("fast8", B * T), input_proj_fn("block", B * T)
            ref = blk(xp.float(), wp)
            for name, fn in (("kernel B", r8), ("block", blk)):
                _gate(f"input projection {name} K{k}", _errors(fn(xp, wp), ref), TOL_BF16)
            arms[k] = _alternating(lambda: r8(xp, wp), lambda: blk(xp, wp), 5)
            del xp, ref
    torch.cuda.empty_cache()
    print(f"phase 7 timing on {smi}: encoder fwd B{B}xT{T} kernel {fwd_k:.3f} ms "
          f"({audio_s / fwd_k * 1e3:.1f} audio-s/s), plain {fwd_p:.3f} ms "
          f"({audio_s / fwd_p * 1e3:.1f} audio-s/s); qlstm_scan8 T{T} B{B} H{H} D2 bf16 kernel "
          f"{d_k:.3f} ms ({d_k / T * 1e3:.2f} us a step) plain {d_p:.3f} ms bound "
          f"{bound_d[0]:.4f} ms ({bound_d[1]}); one QBiLSTM layer ({2 * H} in) kernel path "
          f"{layer_ms:.3f} ms, cuDNN LSTM fp16 {lib_fp16:.3f} ms, nn.LSTM bf16 {lib_bf16:.3f} ms "
          f"(cuDNN takes bf16, fp16: {cudnn_ok}); input projection M{B * T} N{8 * H}: "
          + "; ".join(f"K{k} kernel B {a[0]:.3f} ms block {a[1]:.3f} ms" for k, a in arms.items()),
          flush=True)
    print(f"phase 7 profile on {smi}: one encoder forward B{B}xT{T} (kernel path, "
          f"torch.profiler) {wall_ms:.3f} ms on the host clock, kernels busy {busy_ms:.3f} ms "
          f"(device idle {max(0.0, 1 - busy_ms / wall_ms):.1%}); by self device time: "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                      for e in top), flush=True)
    return {"name": "qlstm_scan8", "route": "cuda", "source": "qasr_torch/csrc/qlstm_scan8.cu",
            "replaces": "qasr/ops/pallas/qlstm_scan.py:99 (_fwd_kernel)",
            "launches": counts["qlstm_scan8"], "max_abs_err": max_err, "ms": d_k,
            "plain_ms": d_p, "bound_ms": bound_d[0], "bound_by": bound_d[1],
            "library_ms": lib_fp16,
            "library": "cuDNN nn.LSTM, fp16: the whole bidirectional layer, its input GEMM "
                       "included (no library call computes the recurrence alone)",
            "layer_ms": layer_ms}


def phase8_qlstm_train(dev: torch.device, smi: str) -> dict:
    """Config 4 training at full width; returns kernel E's entry of the
    kernels line."""
    from qasr_torch.configs import get_config
    from qasr_torch.models.qlstm import QBiLSTM, input_proj_fn
    from qasr_torch.ops.initializers import quaternion_init
    from qasr_torch.ops.kernels.qconv_dx8 import qconv_dx8, qconv_dx8_plain
    from qasr_torch.ops.kernels.qconv_ft import qconv_fast8_stacked_plain, qconv_ft8
    from qasr_torch.ops.kernels.qgemm8 import (
        conj_transpose_dense,
        qdense_pallas8,
        qgemm8_cl,
        qgemm8_cl_plain,
        qgemm8_dx,
    )
    from qasr_torch.ops.kernels.qlstm_scan import (
        qlstm_scan_bwd,
        qlstm_scan_bwd_plain,
        qlstm_scan_dw,
        qlstm_scan_fwd,
    )
    from qasr_torch.ops.quaternion import combine_weights
    from qasr_torch.train.state import create_train_state
    from qasr_torch.train.step import train_step

    g = torch.Generator(device=dev).manual_seed(SEED + 8)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    bf16 = torch.bfloat16
    cfg = get_config("librispeech_qlstm")
    T, B, H = cfg.data.bucket_sizes[0], cfg.data.batch_size, cfg.model.lstm_features
    # Kernel E against its plain version at the path's shape, both
    # directions, ragged lengths, on the residuals of a kernel D forward and
    # signed upstream gradients. f32: the products sum in another order
    # (~1e-7 a step), carried in f32 and damped by the forget gates: TOL_F32.
    # bf16: both carry dh and dc in f32 and round dz and dprods (formed from
    # the f32 dz) at the same places (tests/test_torch_qlstm_train.py holds
    # the plain version so against _bwd_xla on the CPU), so they differ where
    # the f32 sum order moves a value across a bf16 rounding boundary (2^-8
    # relative), now and then, and the f32 carry damps that too: TOL_BF16.
    lens = torch.randint(T // 4, T + 1, (B,), generator=g, device=dev)
    lens[0] = T
    xz32 = rnd(T, 2, B, 16 * H, scale=0.5)
    wc32 = torch.stack([
        combine_weights(quaternion_init((4, H, 4 * H), generator=torch.Generator().manual_seed(
            SEED + 10 + d), device=dev)) for d in range(2)])
    dhs32 = rnd(T, 2, B, 4 * H)
    e_err = 0.0
    for dtype, tol in ((torch.float32, TOL_F32), (bf16, TOL_BF16)):
        xz, wc, dhs = xz32.to(dtype), wc32.to(dtype), dhs32.to(dtype)
        with torch.no_grad():
            hs, cs, gates = qlstm_scan_fwd(xz, wc, lens)
        got = qlstm_scan_bwd(wc, gates, cs, dhs, lens)
        again = qlstm_scan_bwd(wc, gates, cs, dhs, lens)
        want = qlstm_scan_bwd_plain(wc, gates, cs, dhs, lens)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise RuntimeError("qlstm_scan8_bwd differs between two runs on the same inputs")
        err = _errors(got, want)
        _report(f"qlstm_scan8_bwd T{T} B{B} H{H} D2 ragged dz {str(dtype)[6:]}", err, tol, 8)
        if dtype == bf16:
            e_err = err["max_abs_err"]
        del got, again, want
    del xz32, dhs32

    # kernel C at the tower's three stacked shapes (B32 F13 T512: 64->64,
    # 64->128, 128->128), with the previous layer's PReLU backward (signed
    # slopes) and without, gated as in phase 3
    conv, nf = cfg.model.conv_features, 13
    for dtype, tol in ((torch.float32, TOL_F32), (bf16, TOL_BF16)):
        dname = str(dtype)[6:]
        for cin, cout in zip(conv[:-1], conv[1:]):
            w = rnd(4, 3, 3, cin, cout, scale=(1.0 / (9 * cin)) ** 0.5)
            dz = rnd(B, 4, nf, T, cout).to(dtype)
            z = rnd(B, 4, nf, T, cin, scale=0.5).to(dtype)
            slopes = rnd(4 * cin, scale=0.25)
            for epi in (False, True):
                zz, sl = (z, slopes) if epi else (None, None)
                dx, da = qconv_dx8(dz, w, zz, sl)
                ref, ref_da = qconv_dx8_plain(dz.float(), w, None if zz is None else zz.float(), sl)
                shape = f"B{B} F{nf} T{T} C{cout}->{cin} k3x3 {dname} epilogue={epi}"
                _report(f"qconv_dx8 {shape} dx", _errors(dx, ref), tol, 8)
                if epi:
                    _report(f"qconv_dx8 {shape} dalpha", _errors(da, ref_da), tol, 8)
            del dz, z, dx, ref
    torch.cuda.empty_cache()

    # kernels A and B at the train step's shapes, which phases 3 and 7 do
    # not reach, against their plain versions, gated as in phase 3. A: the
    # tower's three stacked layers at B32 F13 T512, with the previous
    # layer's PReLU as prologue and its bias, and without (the first stacked
    # layer has no prologue). B: qdense_0 at M = B*T = 16384, K = 2H, N 256,
    # forward and its dx role.
    m, k, n = B * T, 2 * H, cfg.model.dense_features[0]
    for dtype, tol in ((torch.float32, TOL_F32), (bf16, TOL_BF16)):
        dname = str(dtype)[6:]
        for cin, cout in zip(conv[:-1], conv[1:]):
            w = rnd(4, 3, 3, cin, cout, scale=(1.0 / (9 * cin)) ** 0.5)
            bias, alpha = rnd(4 * cout, scale=0.1), rnd(4 * cin, scale=0.25).abs()
            x = rnd(B, 4, nf, T, cin, scale=0.5).to(dtype)
            for bb, aa in ((None, None), (bias, alpha)):
                err = _errors(qconv_ft8(x, w, bb, aa),
                              qconv_fast8_stacked_plain(x.float(), w, bb, aa))
                _report(f"qconv_ft8 B{B} F{nf} T{T} C{cin}->{cout} k3x3 {dname} "
                        f"prologue+bias={bb is not None}", err, tol, 8)
            del x
        w = rnd(4, k, n, scale=(1.0 / k) ** 0.5)
        x4, dy4 = rnd(4, m, k, scale=0.5).to(dtype), rnd(4, m, n).to(dtype)
        _report(f"qgemm8 M{m} K{k} N{n} {dname}",
                _errors(qgemm8_cl(x4, w), qgemm8_cl_plain(x4.float(), w)), tol, 8)
        _report(f"qgemm8_dx M{m} N{n} -> K{k} {dname}",
                _errors(qgemm8_dx(dy4, w), qgemm8_cl_plain(dy4.float(), conj_transpose_dense(w))),
                tol, 8)
        del x4, dy4
    torch.cuda.empty_cache()

    # The training configuration: librispeech_qlstm at full width on
    # synthetic data (the corpus does not ship with the repo), one 512-frame
    # bucket, a 2-step warmup and the 1e-4 peak rate of phase 6. The fixed
    # batch: the preset's 32 utterances, ragged, 128-512 frames (zero past
    # each length, as batching pads), one character label per 8 frames.
    tcfg = cfg.override(**{"data.dataset": "synthetic", "data.bucket_sizes": (T,),
                           "data.max_label_len": T // 8, "train.warmup_steps": 2,
                           "train.learning_rate": 1e-4})
    brng = np.random.default_rng(SEED + 8)
    flen = brng.integers(T // 4, T + 1, size=B).astype(np.int32)
    flen[0] = T
    feats = brng.standard_normal((B, T, tcfg.data.n_mels, 4)).astype(np.float32)
    feats[np.arange(T)[None, :] >= flen[:, None]] = 0.0
    batch = {
        "features": feats, "feature_lengths": flen,
        "labels": brng.integers(1, tcfg.model.vocab, size=(B, T // 8)).astype(np.int32),
        "label_lengths": (flen // 8).astype(np.int32), "real_rows": np.ones(B, bool),
    }
    audio_s = B * T * FRAME_S

    # Error model: phase 6's (rounding at each layer boundary, forward and
    # backward, and the PReLU kink in bf16; summation order in f32), over
    # fewer boundaries (four convs, three input projections, the dense and
    # the output layer: 9 forward, 9 backward, against config 2's 26), plus
    # three recurrences of 512 steps forward (kernel D) and backward (kernel
    # E). Each recurrence's two paths carry their state at the same
    # precision and round at the same places; they differ by ~1.3e-3 after
    # 512 steps in bf16 and ~1e-7 in f32 (the parity above and phase 7),
    # damped by the forget gates rather than compounded. So phase 6's limits
    # hold: bf16 1.5e-1 a gradient, loss 1e-2; f32 with slopes 1, 1e-4.
    _grad_parity(tcfg, batch, dev, 8, f"config 4 B{B}xT{T} ragged: ")

    # the main path: launches of one train step, then twenty steps on the
    # fixed batch
    state = create_train_state(tcfg, device=dev)
    enc = state.model
    if enc.recurrent != "pallas8" or sum(enc.stacked) != 3 or not enc.training:
        raise RuntimeError(f"config 4 train routing: recurrent {enc.recurrent}, stacked "
                           f"{enc.stacked}, training {enc.training}")
    n_b = enc.n_dense + sum(
        input_proj_fn(getattr(enc, f"qbilstm_{i}").input_proj, B * T) is qdense_pallas8
        for i in range(enc.lstm_layers))
    _reset_counts()
    losses = [train_step(state, batch)["loss"].item()]
    step_counts = _read_counts()
    want = {"qconv_ft8": 3, "qconv_dx8": 3, "qgemm8": n_b, "qgemm8_dx": n_b, "qlstm_scan8": 3,
            "qlstm_scan8_bwd": 3}
    if step_counts != want or n_b != 1:
        raise RuntimeError(f"config 4 launches in one train step {step_counts}, expected {want}")
    for _ in range(19):
        losses.append(train_step(state, batch)["loss"].item())
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise RuntimeError(f"config 4: twenty steps on one batch did not lower the loss: {losses}")
    print(f"phase 8 train steps: config 4 B{B}xT{T} bf16, launches per step {step_counts} "
          f"(input projections at M={B * T} on the block product); loss over 20 steps on one "
          f"batch (dropout {tcfg.model.dropout_rate}) {losses[0]:.4f} -> {losses[-1]:.4f}",
          flush=True)
    del state, enc
    torch.cuda.empty_cache()

    # the main path's end to end: one train() call (4 steps, an eval over
    # the synthetic set, a checkpoint) and a Transcriber serving it
    rng = np.random.default_rng(SEED + 8)
    wavs = [(0.1 * rng.standard_normal(int(n_s * cfg.data.sample_rate))).astype(np.float32)
            for n_s in (2.2, 4.1)]
    lcfg = tcfg.override(**{"train.num_steps": 4, "train.log_every": 2, "train.eval_every": 4,
                            "train.checkpoint_every": 4})
    last, train_counts, hyp, train_s = _train_and_serve(
        lcfg, dev, "smoke_train_qlstm", wavs, {"qlstm_scan8_bwd": 3, "qconv_dx8": 3})
    print(f"phase 8 train(): librispeech_qlstm full width, {lcfg.train.num_steps} steps in "
          f"{train_s:.2f} s, last log {json.dumps({k: last[k] for k in sorted(last)})}; "
          f"launches {train_counts}; checkpoint served {len(hyp)} utterances "
          f"(symbols {[len(h) for h in hyp]})", flush=True)

    # timing (not gated): the train step, kernel path and plain path
    st_k = create_train_state(tcfg, device=dev)
    st_p = create_train_state(tcfg, device=dev)
    step_k, step_p = _alternating(lambda: train_step(st_k, batch),
                                  lambda: train_step(st_p, batch, plain=True), 3, 1, warm=1)
    del st_p
    # where one kernel-path train step's device time goes (torch.profiler)
    cuda = torch.autograd.DeviceType.CUDA
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(st_k, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages() if e.device_type == cuda]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    del st_k
    torch.cuda.empty_cache()

    # kernel E against its plain version and its bound (bf16), f32 too;
    # the dW einsums
    wc = wc32.to(bf16)
    xz = rnd(T, 2, B, 16 * H, scale=0.5).to(bf16)
    dhs = rnd(T, 2, B, 4 * H).to(bf16)
    with torch.no_grad():
        hs, cs, gates = qlstm_scan_fwd(xz, wc, lens)
    del xz
    e_k, e_p = _alternating(lambda: qlstm_scan_bwd(wc, gates, cs, dhs, lens),
                            lambda: qlstm_scan_bwd_plain(wc, gates, cs, dhs, lens), 5, 1, warm=1)
    # gates, cs and dhs in, dz (as gates) out, wc8 once
    bound_e = _bound(2 * 8 * T * 2 * B * H * 4 * H,
                     2 * _nbytes(gates) + _nbytes(cs, dhs) + _nbytes(wc))
    dz = qlstm_scan_bwd(wc, gates, cs, dhs, lens)
    dw_ms = _time_ms(lambda: qlstm_scan_dw(hs, dz), 5)
    g32 = [v.float() for v in (wc, gates, cs, dhs)]
    e32 = _time_ms(lambda: qlstm_scan_bwd(*g32, lens), 3, 1)
    del hs, cs, gates, dhs, dz, g32
    torch.cuda.empty_cache()

    # the library yardstick: one QBiLSTM layer (layer 1's shape: 2H in)
    # forward and backward on the kernel path, against one cuDNN nn.LSTM
    # (bidirectional, hidden 4H, the expanded weights) forward and backward
    # in fp16; neither is gated, the port never calls nn.LSTM
    layer = QBiLSTM(2 * H, H, dtype=bf16, recurrent="pallas8", device=dev,
                    generator=torch.Generator().manual_seed(SEED + 3))
    xl = rnd(B, T, 8 * H, scale=0.5).to(bf16).requires_grad_()
    dy = rnd(B, T, 8 * H).to(bf16)

    def layer_step():
        layer.zero_grad(set_to_none=True)
        xl.grad = None
        layer(xl).backward(dy)

    layer_ms = _time_ms(layer_step, 3)
    lstm = _cudnn_lstm(layer, torch.float16)
    xf = xl.detach().to(torch.float16).requires_grad_()
    dyf = dy.to(torch.float16)

    def lib_step():
        lstm.zero_grad(set_to_none=True)
        xf.grad = None
        lstm(xf)[0].backward(dyf)

    lib_ms = _time_ms(lib_step, 3)
    del layer, lstm, xl, xf, dy, dyf
    torch.cuda.empty_cache()

    # kernel C at the tower's three stacked shapes, as the train step runs
    # them (the first stacked layer without the PReLU backward), bf16
    c_times = []
    for i, (cin, cout) in enumerate(zip(conv[:-1], conv[1:])):
        w = rnd(4, 3, 3, cin, cout, scale=(1.0 / (9 * cin)) ** 0.5)
        dz = rnd(B, 4, nf, T, cout).to(bf16)
        zz, sl = (rnd(B, 4, nf, T, cin, scale=0.5).to(bf16), rnd(4 * cin, scale=0.25)) if i else (
            None, None)
        ck, cp = _alternating(lambda: qconv_dx8(dz, w, zz, sl),
                              lambda: qconv_dx8_plain(dz, w, zz, sl), 5)
        # dz (and z_prev) in, dx out, the weight combos (and slopes, dalpha)
        nbytes = _nbytes(dz) + (2 if i else 1) * _nbytes(dz) * cin // cout + 8 * 9 * cin * cout * 2
        bound = _bound(2 * 8 * B * nf * T * cin * cout * 9, nbytes)
        c_times.append((cin, cout, i > 0, ck, cp, bound[0]))
        del w, dz, zz
    torch.cuda.empty_cache()

    # the input projection's two arms, forward alone and forward plus
    # backward (dx and dW), at M = B*T rows, N = 2 directions x 4H, K = the
    # tower's F*C (layer 0) and 2H (layers 1-2), bf16 compute on f32 weights
    cross = []
    for k in (nf * conv[-1], 2 * H):
        for m in (2048, 4096, 8192, 16384):
            xp = rnd(m, 4 * k, scale=0.5).to(bf16).requires_grad_()
            wp = rnd(4, k, 8 * H, scale=k ** -0.5).requires_grad_()
            dyp = rnd(m, 4 * 8 * H).to(bf16)
            row = {"K": k, "M": m}
            for name in ("fast8", "block"):
                fn = input_proj_fn(name, m)
                with torch.no_grad():
                    row[f"{name}_fwd"] = _time_ms(lambda: fn(xp, wp.to(bf16)), 5)

                def fwd_bwd():
                    xp.grad = None
                    wp.grad = None
                    fn(xp, wp.to(bf16)).backward(dyp)

                row[f"{name}_fwd_bwd"] = _time_ms(fwd_bwd, 5)
            cross.append(row)
            del xp, wp, dyp
    torch.cuda.empty_cache()

    print(f"phase 8 timing on {smi}: config 4 train step B{B}xT{T} bf16 kernel path "
          f"{step_k:.3f} ms ({audio_s / step_k * 1e3:.1f} audio-s/s), plain path {step_p:.3f} ms "
          f"({audio_s / step_p * 1e3:.1f} audio-s/s); qlstm_scan8_bwd T{T} B{B} H{H} D2 bf16 "
          f"kernel {e_k:.3f} ms ({e_k / T * 1e3:.2f} us a step) plain {e_p:.3f} ms bound "
          f"{bound_e[0]:.4f} ms ({bound_e[1]}); f32 kernel {e32:.3f} ms ({e32 / T * 1e3:.2f} us "
          f"a step); dW einsums {dw_ms:.3f} ms; one QBiLSTM layer ({2 * H} in) forward + "
          f"backward on the kernel path {layer_ms:.3f} ms, cuDNN nn.LSTM fp16 forward + "
          f"backward {lib_ms:.3f} ms; qconv_dx8 B{B} F{nf} T{T} bf16: " + "; ".join(
              f"C{co}->{ci} epilogue={e} kernel {k:.3f} ms plain {p:.3f} ms bound {bd:.3f} ms"
              for ci, co, e, k, p, bd in c_times), flush=True)
    print(f"phase 8 crossover on {smi} (input projection, N{8 * H} bf16, ms; kernel B = "
          "fast8, block = the expanded matmul): " + "; ".join(
              f"K{r['K']} M{r['M']}: fwd kernel B {r['fast8_fwd']:.3f} block "
              f"{r['block_fwd']:.3f}, fwd+bwd kernel B {r['fast8_fwd_bwd']:.3f} block "
              f"{r['block_fwd_bwd']:.3f}" for r in cross), flush=True)
    print(f"phase 8 profile on {smi}: one config 4 train step B{B}xT{T} (kernel path, "
          f"torch.profiler) {wall_ms:.3f} ms on the host clock, kernels busy {busy_ms:.3f} ms "
          f"(device idle {max(0.0, 1 - busy_ms / wall_ms):.1%}); by self device time: "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                      for e in top), flush=True)
    return {"name": "qlstm_scan8_bwd", "route": "cuda",
            "source": "qasr_torch/csrc/qlstm_scan8_bwd.cu",
            "replaces": "qasr/ops/pallas/qlstm_scan.py:264 (_bwd_kernel)",
            "launches": step_counts["qlstm_scan8_bwd"], "max_abs_err": e_err, "ms": e_k,
            "plain_ms": e_p, "bound_ms": bound_e[0], "bound_by": bound_e[1],
            "library_ms": lib_ms,
            "library": "cuDNN nn.LSTM, fp16, forward + backward: the whole bidirectional "
                       "layer, its input GEMM included (no library call computes the "
                       "recurrence's backward alone)",
            "layer_ms": layer_ms}


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    from qasr_torch.configs import get_config
    from qasr_torch.infer import Transcriber, _next_time_pad
    from qasr_torch.models import build_model
    from qasr_torch.ops.kernels import _build
    from qasr_torch.ops.kernels.qconv_chain import qconv_dw8
    from qasr_torch.ops.kernels.qconv_dx8 import conj_transpose_w, qconv_dx8, qconv_dx8_plain
    from qasr_torch.ops.kernels.qconv_ft import qconv_fast8_stacked_plain, qconv_ft8
    from qasr_torch.ops.kernels.qgemm8 import (
        conj_transpose_dense,
        qgemm8_cl,
        qgemm8_cl_plain,
        qgemm8_dx,
    )
    from qasr_torch.ops.quaternion import hamilton_expand
    from qasr_torch.train.state import create_train_state
    from qasr_torch.train.step import train_step

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = f"{smi} (torch {torch.__version__}, CUDA {torch.version.cuda})"
    print(f"phase 1 device: {card}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.load_library()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"phase 2 build: {build_s:.2f} s (nvcc {_build.build_seconds:.2f} s) "
          f"-> {_build.LIB_PATH}", flush=True)

    # 3. parity against the plain versions, same inputs
    g = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    results = {}
    for b, f, t, c, ks in ((2, 13, 256, 256, (3, 3)), (2, 13, 250, 256, (3, 3)),
                           (1, 5, 40, 16, (3, 5))):
        w = rnd(4, *ks, c, c, scale=(1.0 / (ks[0] * ks[1] * c)) ** 0.5)
        bias = rnd(4 * c, scale=0.1)
        alpha = rnd(4 * c, scale=0.25).abs()
        slopes = rnd(4 * c, scale=0.25)  # kernel C: signed, so alpha < 0 is covered
        x32 = rnd(b, 4, f, t, c, scale=0.5)
        dz32 = rnd(b, 4, f, t, c)
        shape = f"B{b} F{f} T{t} C{c} k{ks[0]}x{ks[1]}"
        for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
            x, dz = x32.to(dtype), dz32.to(dtype)
            dname = str(dtype)[6:]
            for bb, aa in ((None, None), (bias, alpha)):
                got = qconv_ft8(x, w, bb, aa)
                ref = qconv_fast8_stacked_plain(x.float(), w, bb, aa)
                err = _errors(got, ref)
                _report(f"qconv_ft8 {shape} {dname} prologue+bias={bb is not None}", err, tol)
                if (t, dtype, bb is not None) == (256, torch.bfloat16, True):
                    results["qconv_ft8"] = err["max_abs_err"]
            for epi in (False, True):
                zz, sl = (x, slopes) if epi else (None, None)
                got, got_da = qconv_dx8(dz, w, zz, sl)
                ref, ref_da = qconv_dx8_plain(dz.float(), w, None if zz is None else zz.float(), sl)
                err = _errors(got, ref)
                _report(f"qconv_dx8 {shape} {dname} epilogue={epi} dx", err, tol)
                if epi:
                    da_err = _errors(got_da, ref_da)
                    _report(f"qconv_dx8 {shape} {dname} epilogue=True dalpha", da_err, tol)
                elif got_da is not None:
                    raise RuntimeError("qconv_dx8 without its epilogue returned a dalpha")
                if (t, dtype, epi) == (256, torch.bfloat16, True):
                    results["qconv_dx8"] = max(err["max_abs_err"], da_err["max_abs_err"])
                    # dalpha is reduced without atomics: the same bits every run
                    again, again_da = qconv_dx8(dz, w, zz, sl)
                    if not (torch.equal(again, got) and torch.equal(again_da, got_da)):
                        raise RuntimeError("qconv_dx8 differs between two runs on the same inputs")
    for m, k, n in ((4096, 3328, 256), (1000, 3328, 256), (4096, 256, 256), (1000, 256, 256)):
        w = rnd(4, k, n, scale=(1.0 / k) ** 0.5)
        x32 = rnd(4, m, k, scale=0.5)
        dy32 = rnd(4, m, n)
        for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
            x4, dy4 = x32.to(dtype), dy32.to(dtype)
            dname = str(dtype)[6:]
            err = _errors(qgemm8_cl(x4, w), qgemm8_cl_plain(x4.float(), w))
            _report(f"qgemm8 M{m} K{k} N{n} {dname}", err, tol)
            if (m, k, dtype) == (4096, 3328, torch.bfloat16):
                results["qgemm8"] = err["max_abs_err"]
            err = _errors(qgemm8_dx(dy4, w), qgemm8_cl_plain(dy4.float(), conj_transpose_dense(w)))
            _report(f"qgemm8_dx M{m} N{n} -> K{k} {dname}", err, tol)
            if (m, k, dtype) == (4096, 3328, torch.bfloat16):
                results["qgemm8_dx"] = err["max_abs_err"]

    # 4. serving: the port's serving path, full width
    cfg = get_config("timit_qcnn")
    model = build_model(cfg, generator=torch.Generator().manual_seed(SEED), device=dev)
    params = model.state_dict()
    del model
    greedy = Transcriber(cfg=cfg, params=params, device=dev)
    beam = Transcriber(cfg=cfg, params=params, device=dev, beam=True)
    rng = np.random.default_rng(SEED)
    wavs = []
    for n_s in rng.uniform(1.0, 3.0, size=4):
        n = int(n_s * cfg.data.sample_rate)
        env = np.abs(np.sin(np.linspace(0, 6 * np.pi, n)))  # syllable-like bursts
        wavs.append((0.1 * env * rng.standard_normal(n)).astype(np.float32))
    _reset_counts()
    hyp_greedy = greedy.transcribe_batch(wavs)
    hyp_beam = beam.transcribe_batch(wavs)
    serve_counts = _read_counts()
    n_fat = sum(greedy.model.stacked)
    n_dense = greedy.model.n_dense
    want = {"qconv_ft8": 2 * n_fat, "qgemm8": 2 * n_dense, "qgemm8_dx": 0,
            "qconv_dx8": 0, "qlstm_scan8": 0, "qlstm_scan8_bwd": 0}  # two forwards
    if serve_counts != want or n_fat != 9 or n_dense != 3:
        raise RuntimeError(f"serving launches {serve_counts}, expected {want}")
    logits, lengths = greedy.logits(wavs)
    logits_plain, _ = greedy.logits(wavs, plain=True)
    torch.cuda.synchronize()
    want_shape = (4, _next_time_pad(max(lengths.tolist()), cfg.data.bucket_sizes), cfg.model.vocab)
    if tuple(logits.shape) != want_shape:
        raise RuntimeError(f"logits shape {tuple(logits.shape)}, expected {want_shape}")
    cfg32 = cfg.override(**{"model.compute_dtype": "float32"})
    logits_f32, _ = Transcriber(cfg=cfg32, params=params, device=dev).logits(wavs, plain=True)
    torch.cuda.synchronize()
    lerr = _errors(logits, logits_plain)
    _gate("serving logits kernel vs plain", lerr, TOL_LOGITS)
    kerr32 = _errors(logits, logits_f32)
    _gate("serving logits kernel vs f32 plain", kerr32, TOL_LOGITS_F32)
    perr32 = _errors(logits_plain, logits_f32)
    _gate("serving logits plain bf16 vs f32 plain", perr32, TOL_LOGITS_F32)
    print(f"phase 4 serving: timit_qcnn QCNN-256 bf16, {len(wavs)} utterances "
          f"({', '.join(f'{len(w) / cfg.data.sample_rate:.2f}' for w in wavs)} s), "
          f"logits {tuple(logits.shape)} finite; launches per forward "
          f"qconv_ft8 {serve_counts['qconv_ft8'] // 2} qgemm8 {serve_counts['qgemm8'] // 2}; "
          f"greedy phones {[len(h) for h in hyp_greedy]}, beam (W={cfg.decode.beam_width}, "
          f"prune {cfg.decode.beam_prune_logp}) phones {[len(h) for h in hyp_beam]}; "
          f"logits kernel vs plain max_abs {lerr['max_abs_err']:.3e} "
          f"rel_norm {lerr['rel_norm']:.3e} (tol {TOL_LOGITS}); against the f32 plain "
          f"path: kernel rel_norm {kerr32['rel_norm']:.3e}, bf16 plain rel_norm "
          f"{perr32['rel_norm']:.3e} (tol {TOL_LOGITS_F32})", flush=True)

    # The training configuration: timit_qcnn at full width on synthetic data
    # (the corpus does not ship with the repo), 40 mels, 62 classes, one
    # 256-frame bucket, a 2-step warmup. The preset's peak rate of 1e-3 is
    # reached after 500 warmup steps; after 2, its first updates overshoot
    # and the loss diverges on the kernel and the plain path alike, so the
    # short runs here train at 1e-4. The fixed batch is TIMIT-like: 16
    # utterances of 256 frames (2.56 s) with 40 phone labels each.
    tcfg = cfg.override(**{"data.dataset": "synthetic", "data.n_mels": 40, "model.vocab": 62,
                           "data.bucket_sizes": (256,), "train.warmup_steps": 2,
                           "train.learning_rate": 1e-4})
    brng = np.random.default_rng(SEED + 1)
    batch = {
        "features": brng.standard_normal((16, 256, 40, 4)).astype(np.float32),
        "feature_lengths": np.full(16, 256, np.int32),
        "labels": brng.integers(1, 62, size=(16, tcfg.data.max_label_len)).astype(np.int32),
        "label_lengths": np.full(16, 40, np.int32),
        "real_rows": np.ones(16, bool),
    }
    train_audio_s = 16 * 256 * FRAME_S

    # 5. timing (informational), at the paths' shapes
    enc = greedy.model
    feats = rnd(16, 256, cfg.data.n_mels, 4)
    audio_s = 16 * 256 * FRAME_S
    timing = {}
    with torch.no_grad():
        fwd_k, fwd_p = _alternating(lambda: enc(feats), lambda: enc(feats, plain=True), 5)
        # kernel A and its library call: one F.conv2d on the Hamilton-expanded
        # weight over the packed NCHW input (the equal-width real conv)
        xa = rnd(16, 4, 13, 256, 256, scale=0.5).to(torch.bfloat16)
        wa = rnd(4, 3, 3, 256, 256, scale=0.02)
        ba, aa = rnd(1024, scale=0.1), rnd(1024, scale=0.25).abs()
        timing["qconv_ft8"] = _alternating(lambda: qconv_ft8(xa, wa, ba, aa),
                                           lambda: qconv_fast8_stacked_plain(xa, wa, ba, aa), 10)
        xa_lib = xa.permute(0, 1, 4, 2, 3).reshape(16, 1024, 13, 256).contiguous()
        wa_lib = hamilton_expand(wa).permute(3, 2, 1, 0).contiguous().to(torch.bfloat16)
        lib = F.conv2d(xa_lib, wa_lib, padding=1)
        ref = qconv_fast8_stacked_plain(xa.float(), wa).permute(0, 1, 4, 2, 3)
        ref = ref.reshape(16, 1024, 13, 256)
        _gate("library conv2d for kernel A", _errors(lib, ref), TOL_BF16)
        lib_a = _time_ms(lambda: F.conv2d(xa_lib, wa_lib, padding=1), 10)
        fl_a = 2 * 8 * 16 * 13 * 256 * 256 * 256 * 9
        bound_a = _bound(fl_a, 2 * _nbytes(xa) + 8 * 9 * 256 * 256 * 2 + _nbytes(ba, aa))
        # kernel C, epilogue on; its library call: one F.conv2d on the
        # expanded adjoint weight (the transposed conv without the epilogue)
        dza = rnd(16, 4, 13, 256, 256).to(torch.bfloat16)
        sa = rnd(1024, scale=0.25)
        timing["qconv_dx8"] = _alternating(lambda: qconv_dx8(dza, wa, xa, sa),
                                           lambda: qconv_dx8_plain(dza, wa, xa, sa), 10)
        dza_lib = dza.permute(0, 1, 4, 2, 3).reshape(16, 1024, 13, 256).contiguous()
        wc_lib = hamilton_expand(conj_transpose_w(wa)).permute(3, 2, 1, 0).contiguous()
        wc_lib = wc_lib.to(torch.bfloat16)
        lib = F.conv2d(dza_lib, wc_lib, padding=1)
        ref = qconv_dx8_plain(dza.float(), wa)[0].permute(0, 1, 4, 2, 3)
        ref = ref.reshape(16, 1024, 13, 256)
        _gate("library conv2d for kernel C", _errors(lib, ref), TOL_BF16)
        lib_c = _time_ms(lambda: F.conv2d(dza_lib, wc_lib, padding=1), 10)
        # dz and z_prev in, dx out, the combos, slopes in and dalpha out
        bound_c = _bound(fl_a, 3 * _nbytes(dza) + 8 * 9 * 256 * 256 * 2 + 2 * _nbytes(sa))
        # kernel C without its epilogue (the first stacked layer's dx)
        c0_k, c0_p = _alternating(lambda: qconv_dx8(dza, wa), lambda: qconv_dx8_plain(dza, wa), 10)
        # the layer's dW (plain PyTorch: eight cuDNN weight-gradient convs)
        dw_ms = _time_ms(lambda: qconv_dw8(xa, dza, (3, 3)), 5)
        # kernel B, forward and dx role, and their library calls: one matmul
        # on the Hamilton-expanded weight
        xb = rnd(4, 4096, 3328, scale=0.5).to(torch.bfloat16)
        wb = rnd(4, 3328, 256, scale=0.02)
        timing["qgemm8"] = _alternating(lambda: qgemm8_cl(xb, wb),
                                        lambda: qgemm8_cl_plain(xb, wb), 10)
        xb_lib = xb.permute(1, 0, 2).reshape(4096, 4 * 3328).contiguous()
        wb_lib = hamilton_expand(wb).to(torch.bfloat16)
        lib_b = _time_ms(lambda: torch.matmul(xb_lib, wb_lib), 10)
        fl_b = 2 * 8 * 4096 * 3328 * 256
        bound_b = _bound(fl_b, _nbytes(xb) + 8 * 3328 * 256 * 2 + 4 * 4096 * 256 * 2)
        dyb = rnd(4, 4096, 256).to(torch.bfloat16)
        wbt = conj_transpose_dense(wb)
        timing["qgemm8_dx"] = _alternating(lambda: qgemm8_dx(dyb, wb),
                                           lambda: qgemm8_cl_plain(dyb, wbt), 10)
        dyb_lib = dyb.permute(1, 0, 2).reshape(4096, 4 * 256).contiguous()
        wbt_lib = hamilton_expand(wbt).to(torch.bfloat16)
        lib_bdx = _time_ms(lambda: torch.matmul(dyb_lib, wbt_lib), 10)
        bound_bdx = _bound(fl_b, _nbytes(dyb) + 8 * 3328 * 256 * 2 + _nbytes(xb))
        xb2 = rnd(4, 4096, 256, scale=0.5).to(torch.bfloat16)
        wb2 = rnd(4, 256, 256, scale=0.05)
        b2_k, b2_p = _alternating(lambda: qgemm8_cl(xb2, wb2),
                                  lambda: qgemm8_cl_plain(xb2, wb2), 10)
        xb2_lib = xb2.permute(1, 0, 2).reshape(4096, 1024).contiguous()
        wb2_lib = hamilton_expand(wb2).to(torch.bfloat16)
        lib_b2 = _time_ms(lambda: torch.matmul(xb2_lib, wb2_lib), 10)
        bound_b2 = _bound(2 * 8 * 4096 * 256 * 256,
                          _nbytes(xb2) + 8 * 256 * 256 * 2 + _nbytes(xb2))
    del xa, dza, xa_lib, dza_lib, xb, xb_lib, dyb, dyb_lib, lib, ref
    # one train step, kernel path against plain path, on the fixed batch
    st_k = create_train_state(tcfg, device=dev)
    st_p = create_train_state(tcfg, device=dev)
    step_k, step_p = _alternating(lambda: train_step(st_k, batch),
                                  lambda: train_step(st_p, batch, plain=True), 3)
    del st_k, st_p
    torch.cuda.empty_cache()
    tk = timing
    print(f"phase 5 timing on {smi}: encoder fwd B16xT256 kernel {fwd_k:.3f} ms "
          f"({audio_s / fwd_k * 1e3:.1f} audio-s/s), plain {fwd_p:.3f} ms "
          f"({audio_s / fwd_p * 1e3:.1f} audio-s/s); train step B16xT256 kernel "
          f"{step_k:.3f} ms ({train_audio_s / step_k * 1e3:.1f} audio-s/s), plain "
          f"{step_p:.3f} ms ({train_audio_s / step_p * 1e3:.1f} audio-s/s)", flush=True)
    print(f"phase 5 timing on {smi}: qconv_ft8 B16 F13 T256 C256 kernel "
          f"{tk['qconv_ft8'][0]:.3f} ms plain {tk['qconv_ft8'][1]:.3f} ms library "
          f"{lib_a:.3f} ms bound {bound_a[0]:.3f} ms; qconv_dx8 same shape kernel "
          f"{tk['qconv_dx8'][0]:.3f} ms plain {tk['qconv_dx8'][1]:.3f} ms library "
          f"{lib_c:.3f} ms bound {bound_c[0]:.3f} ms; qconv_dx8 without epilogue kernel "
          f"{c0_k:.3f} ms plain {c0_p:.3f} ms; conv dW (cuDNN) {dw_ms:.3f} ms; "
          f"qgemm8 M4096 K3328 N256 kernel "
          f"{tk['qgemm8'][0]:.3f} ms plain {tk['qgemm8'][1]:.3f} ms library {lib_b:.3f} ms "
          f"bound {bound_b[0]:.3f} ms; qgemm8_dx M4096 N256 -> K3328 kernel "
          f"{tk['qgemm8_dx'][0]:.3f} ms plain {tk['qgemm8_dx'][1]:.3f} ms library "
          f"{lib_bdx:.3f} ms bound {bound_bdx[0]:.3f} ms; qgemm8 M4096 K256 N256 kernel "
          f"{b2_k:.3f} ms plain {b2_p:.3f} ms library {lib_b2:.3f} ms bound "
          f"{bound_b2[0]:.4f} ms ({bound_b2[1]}); build {build_s:.2f} s", flush=True)

    # 6. training: the port's training path, full width
    # gradient parity, kernel path against plain path, dropout off
    _grad_parity(tcfg, batch, dev, 6)

    # launches of one train step, and twenty steps on the fixed batch
    state = create_train_state(tcfg, device=dev)
    _reset_counts()
    losses = [train_step(state, batch)["loss"].item()]
    step_counts = _read_counts()
    want = {"qconv_ft8": 9, "qconv_dx8": 9, "qgemm8": 3, "qgemm8_dx": 3, "qlstm_scan8": 0,
            "qlstm_scan8_bwd": 0}
    if step_counts != want:
        raise RuntimeError(f"launches in one train step {step_counts}, expected {want}")
    for _ in range(19):
        losses.append(train_step(state, batch)["loss"].item())
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise RuntimeError(f"twenty steps on one batch did not lower the loss: {losses}")
    print(f"phase 6 train steps: launches per step {step_counts}; loss over 20 steps on one "
          f"batch (dropout {tcfg.model.dropout_rate}) {losses[0]:.4f} -> {losses[-1]:.4f}",
          flush=True)
    del state
    # the preset's peak rate (1e-3) after the same 2-step warmup, on both
    # paths (not gated): why the runs here train at 1e-4
    rate = {}
    for plain in (False, True):
        st = create_train_state(tcfg.override(**{"train.learning_rate": 1e-3}), device=dev)
        rate[plain] = [round(train_step(st, batch, plain=plain)["loss"].item(), 3)
                       for _ in range(6)]
        del st
    print(f"phase 6 train rate 1e-3 (not gated): loss over 6 steps kernel path {rate[False]}, "
          f"plain path {rate[True]}", flush=True)
    torch.cuda.empty_cache()

    # the main path: one train() call (4 steps, an eval over the synthetic
    # set, a checkpoint) and a Transcriber serving that checkpoint
    lcfg = tcfg.override(**{"train.num_steps": 4, "train.log_every": 2,
                            "train.eval_every": 4, "train.checkpoint_every": 4})
    last, train_counts, hyp, train_s = _train_and_serve(
        lcfg, dev, "smoke_train", wavs, {"qconv_dx8": 9, "qgemm8_dx": 3})
    print(f"phase 6 train(): {lcfg.model.conv_features[0]}-wide qcnn, {lcfg.train.num_steps} "
          f"steps in {train_s:.2f} s, last log {json.dumps({k: last[k] for k in sorted(last)})}; "
          f"launches {train_counts}; checkpoint served {len(hyp)} utterances "
          f"(phones {[len(h) for h in hyp]})", flush=True)

    # 7. config 4 serving (its own launch counts)
    scan_entry = phase7_qlstm(dev, smi)
    # 8. config 4 training (its own launch counts)
    scan_bwd_entry = phase8_qlstm_train(dev, smi)

    def entry(name, source, replaces, bound, lib_ms):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": train_counts[name], "max_abs_err": results[name],
                "ms": timing[name][0], "plain_ms": timing[name][1], "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": lib_ms}

    _line(kernels=[
        entry("qconv_ft8", "qasr_torch/csrc/qconv_ft8.cu",
              "qasr/ops/pallas/qconv_ft.py:120 (fwd); qasr/ops/pallas/qconv_chain.py:118",
              bound_a, lib_a),
        entry("qconv_dx8", "qasr_torch/csrc/qconv_dx8.cu",
              "qasr/ops/pallas/qconv_chain.py:254; qasr/ops/pallas/qconv_ft.py:120 (dx role)",
              bound_c, lib_c),
        entry("qgemm8", "qasr_torch/csrc/qgemm8.cu", "qasr/ops/pallas/qgemm8.py:84 (fwd)",
              bound_b, lib_b),
        entry("qgemm8_dx", "qasr_torch/csrc/qgemm8.cu",
              "qasr/ops/pallas/qgemm8.py:84 (in_kind=dx)", bound_bdx, lib_bdx),
        scan_entry,
        scan_bwd_entry,
    ])
    print(smi, flush=True)
    _line(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                           "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
