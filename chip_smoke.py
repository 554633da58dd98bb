"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port's serving path and its training path (``qasr_torch``, no
JAX; on synthetic batches and on small synthetic TIMIT and LibriSpeech
corpora) at the full width of ``timit_qcnn`` (the paper's QCNN-256, bf16
compute, random weights from a seeded ``torch.Generator``; also on its
packed XLA conv arms), the serving and training paths of
``librispeech_qlstm`` (its default arm, its block, fast8 and
unidirectional arms and its real ablation), of the real-CNN baseline
``timit_real_cnn`` and of ``librispeech_large`` (config 5, with its
tools and tensor parallelism), and the row-contracting product's probe,
through the hand-written CUDA kernels, and checks them. Phases, one line each (or a
few):

  1. device   the card's name and power limit (nvidia-smi)
  2. build    nvcc build of qasr_torch/csrc/*.cu into qasr_torch/_build/
  3. parity   each kernel (A: the conv, B: the GEMM and its dx role, C: the
              transposed conv with the PReLU backward) against its plain
              PyTorch version on the card, at the paths' shapes, f32
              (tight) and bf16 (loose; A and C also against the bf16 plain
              version), gated; the rank-8 input combos of A, C and B bit for
              bit against the plain versions' (gated); then no
              host-to-device copy in a warmed-up call of kernel B or H,
              forward or dx (gated, torch.profiler)
  4. serving  a Transcriber on four synthetic 1-3 s waveforms, greedy and
              beam; kernel launch counts per forward; kernel-path logits
              against the plain path's, gated
  5. timing   encoder forward and train step at B16 x T256, and each kernel
              at its path shape, against its plain version and one library
              call (CUDA events; not gated); kernel K (the stacked conv's dW
              operands and db) with and without the PReLU, its combos bit
              for bit and its db against its plain version's (gated)
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
              forward + backward against one cuDNN LSTM's (the
              input-projection crossover sweep is
              ``python -m qasr_torch.tools.sweep_input_proj``)
  9. fast10   ``timit_qcnn`` in the 10-product scheme (``op_variant=fused``,
              ``dense_variant=pallas``) at full width: kernels F and G (the
              conv and the transposed conv), H (the GEMM, forward and dx)
              and I (its dW) against their plain versions at the path's
              shapes, f32 and bf16, gated; serving through ``python -m
              qasr_torch.cli transcribe`` and ``transcribe_main``, greedy
              and beam, with launches per forward and logits gates;
              gradient parity, launches per step, twenty steps, and a
              4-step ``main`` run of the command line whose checkpoint
              serves; ``use_pallas`` (im2col convs on H and I), one forward
              and one step with their launches and gradient parity; then,
              not gated, the encoder forward and the train step against the
              rank-8 model (with a torch.profiler breakdown of one step),
              the ``use_pallas`` train step, and each new kernel against
              its plain version, its bound and one library call (kernel I
              with its split S)
 10. dgt and  kernel J (the row-contracting x^T y of benchmarks/probe_dgt.py)
     real CNN against its plain version at the probe's shape (M 65536, K = N
              = 256) and a ragged one (M 65576, K 264, N 136), both modes,
              f32 and bf16, the same bits across modes and runs (gated);
              the probe (``qasr_torch.tools.probe_dgt``) in this process
              with its launches counted, and once as a subprocess; ``timit_real_cnn`` (config 3, the real-CNN
              baseline) at full width: served greedy and beam with its bf16
              logits against f32, twenty steps, one ``train()`` whose
              checkpoint serves (gated; no port kernel runs); then, not
              gated, its train step against the rank-8 QCNN's
              (``vs_baseline``) with a torch.profiler breakdown of one
              real-CNN step, ``conv_roofline`` (block path and
              ``use_pallas``) and kernel J against its plain version, its
              bound and ``torch.matmul`` (CUDA events and graph replays)
 11. corpus   mini-TIMIT (12 train speakers x 8 utterances, 8 dev, 8 core
              test) written by ``qasr_torch.tools.make_mini_timit``,
              featurized on the card and cached; ``timit_qcnn`` at full
              width trained through the command line for 8 steps with a
              dev-split eval and a checkpoint every 4, again interrupted
              after step 4 and ``--resume``d to 8, ``--eval-only`` and a
              ``transcribe`` of the best step; ``librispeech_qlstm`` on mini-LibriSpeech in
              streaming mode, 4 steps with a dev-clean eval (gated: the
              cache built once, the eval set, launches, the resumed run's
              batches, data states and losses, best.json, the eval-only
              PER, the transcribe, streaming against cached features);
              then, not gated, featurization rates, the loop's audio-s/s,
              the dev eval's seconds and the idle share of a corpus step
              against the synthetic step
 12. protocol the paper's decode protocol: kernels A, C (with its epilogue)
              and B (forward and dx) at ``timit_qcnn_fm32``'s shapes (32
              quaternion channels, K = 13 x 32) against their plain
              versions, f32 and bf16 (gated); ``python -m
              qasr_torch.tools.run_timit_protocol --make-mini --preset
              timit_qcnn_fm32 --set train.num_steps=1500`` (the JAX
              package's recorded run, at the preset's schedule) under
              ``qasr_torch/_build/smoke_protocol/``, gated: one JSON line
              with the reference tool's keys, the best-dev-PER step, dev
              and core-test PER <= 0.15 (W = 100 beam, -20 pruning, the
              61->39 fold), launches 9/9/3/3 a step and 9/3 an eval
              forward, and ``--skip-train`` (a subprocess) printing the same
              PERs; the device beam against the host beam on one dev batch
              of the trained model (sequences and lengths equal, scores
              1e-3; gated); then, not gated, the training's seconds and
              audio-s/s, each beam eval's seconds, the two beams' seconds
              on that batch, and a torch.profiler breakdown of one train
              step
 13. qlstm    config 4's other arms at full width (B32 x T512, ragged, bf16):
     arms     kernel B in bf16 against its plain version, whose products
              now stay in f32 until the fold, at phases 3, 7 and 8's shapes
              (gated; the distance to the bf16-product form it replaced
              printed), and the dW's f32-output GEMM on the card against
              f32 operands (gated); then ``op_variant`` block and fast8
              (on the default arm's weights), the unidirectional encoder
              and the real ablation ``real_lstm``: at one LSTM layer (depth
              cut: the plain loops are host-bound) each served, its kernel
              path against its plain path and the f32 plain path, block
              and fast8 against the default arm (f32 plain 1e-4, bf16
              phase 4's limits), launches a forward, gradient parity where
              a kernel is on the path; at full depth launches a step (D and
              E none); at one
              LSTM layer and T128 (depth and length cut: the loops are
              host-bound), twenty steps on one batch lower the loss, a
              2-step ``train()`` (for
              ``real_lstm`` ``python -m qasr_torch.cli``) whose checkpoint a
              Transcriber serves (gated); then, not gated, each arm's
              forward and step, the default step, one RealBiLSTM layer
              against cuDNN's ``nn.LSTM``, a torch.profiler breakdown of a
              block-arm step, and the dW's cost with f32 products against
              bf16 ones
 14. parallel a world of one rank over NCCL through ``python -m
              torch.distributed.run -m qasr_torch.cli``, bit-equal to one
              process; two ranks sharing the card over gloo: DP 2, TP 2 of
              config 5, the halo conv, the chunked CTC and the sharded beam
              against one process (gated)
 15. config 5 ``librispeech_large`` (conv 64..256 x 10, dense 1024 x 3,
              bf16) with its tools: one step with ``train.remat_convs`` off
              and on from the same weights and batch (loss and gradients the
              same bits, launches A 9 / C 9 / B 3 + 3 with remat as without,
              as the stacked layers run bare and only the thin layer is
              recomputed, peak bytes and step ms);
              ``qasr_torch.tools.memory_envelope`` at the reference's seven
              points (every row measured or out of memory,
              remat below no remat, B8 x T2048 fits); the docs' run on
              mini-LibriSpeech through ``python -m qasr_torch.cli`` (400
              of its 1200 steps, cut for time; streaming, B8, dev-clean
              evals, ``best.json`` CER <= 0.15,
              ``--resume``, ``transcribe --beam``); TP 4 on the one card
              through ``torch.distributed.run`` (gloo: losses finite, a
              rank's state 0.25-0.27x, ``--resume``); ``timit_qcnn`` on each
              packed XLA conv arm (logits, gradients against f32, launches);
              ``run_scaling_table`` in a world of one (all gated); then, not
              gated, featurization, step times and a profiled corpus step

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
# Phase 14's chunked CTC against ctc_loss (PyTorch's own alpha-beta), both
# f32 in log space: over T = 256 frames log alpha grows to ~300 nats, where
# f32's spacing is 3.05e-5, so each implementation's log occupancies walk
# off by ~sqrt(256) x 1.5e-5 ~ 2.4e-4, which is the gradients' relative
# error (softmax minus occupancy, |g| <= 1); their difference ~3e-4, its
# largest of 254k elements ~4.5x that. The loss (~300 nats) errs by ~1e-6.
TOL_CTC_GRAD = {"rel_norm": 1e-3, "max_rel": 5e-3}
TOL_CTC_LOSS = {"rel_norm": 1e-5, "max_rel": 1e-5}
# Kernel K's db against its plain version's: both f32 sums of the same
# B*F*T terms a channel in another order, each term's rounding at most
# 2^-24 of the running sum, so the two part by a few 1e-7 of the sum of
# the terms' magnitudes at the most; limit 1e-5 of it, a channel
TOL_DB = 1e-5

FRAME_S = 0.010  # 10 ms hop: one frame is 10 ms of audio
# The training runs of the TIMIT models here (phases 6, 9 and 10; why the
# rate is 1e-4: main, where phase 6 builds its configuration)
TRAIN_OVERRIDES = {"data.dataset": "synthetic", "data.n_mels": 40, "model.vocab": 62,
                   "data.bucket_sizes": (256,), "train.warmup_steps": 2,
                   "train.learning_rate": 1e-4}
# Phase 12: the TIMIT protocol's overrides (the JAX package's recorded run,
# docs/end_to_end.md: the preset's own schedule, peak 1e-3 after 500 warmup
# steps, 1500 steps), the keys of the line tools/run_timit_protocol.py
# prints, and the PER limit (under twice the JAX package's dev 0.0839 and
# core-test 0.0726 on the TPU v5e)
PROTOCOL_SETS = ["train.num_steps=1500"]
PROTOCOL_KEYS = ["protocol", "preset", "step", "selected_by", "beam_width", "beam_prune_logp",
                 "fold", "dev_per", "test_per", "trained_here", "data_dir"]
PROTOCOL_PER_MAX = 0.15
# Kernel B's shapes in phase 3 (M, K, N): config 2's dense layers (K = 13 x
# 256 and 256) at B16 x T256 and at a ragged M; phase 13 holds the plain
# version's f32 products there too
PHASE3_GEMMS = ((4096, 3328, 256), (1000, 3328, 256), (4096, 256, 256), (1000, 256, 256))


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


def _graph_ms(fn, n: int, reps: int = 5) -> float:
    """ms a call of ``fn`` in replays of one CUDA graph of ``n`` calls (the
    host's launch cost out): the least of ``reps`` replays on CUDA events,
    after a warm call and a warm replay."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize()
        best = min(best, e0.elapsed_time(e1) / n)
    return best


def _bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take, in ms: the larger of the
    operations over the bf16 tensor-core peak and the bytes (each input read
    once, each output written once) over the HBM rate, both the H100 SXM
    datasheet's (``qasr_torch.utils.profiling.CHIPS``)."""
    from qasr_torch.utils.profiling import CHIPS

    spec = CHIPS["h100"]
    t_ops, t_bytes = flops / (spec.peak_bf16_tflops * 1e12), nbytes / (spec.hbm_gbps * 1e9)
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _profile(fn, what: str, phase: int, smi: str, n_top: int, named: dict | None = None) -> str:
    """One call of ``fn`` under torch.profiler; returns the line that says
    where its device time goes: host-clock time, kernels busy, the device's
    idle share, the top ``n_top`` kernels by self device time and, for each
    ``label: name part`` (or a tuple of parts) of ``named``, the kernels
    whose name holds a part (their time, calls and share of busy, in or out
    of the top)."""
    cuda = torch.autograd.DeviceType.CUDA
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages() if e.device_type == cuda]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: e.self_device_time_total, reverse=True)[:n_top]
    rows = [f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}" for e in top]
    for label, parts in (named or {}).items():
        parts = (parts,) if isinstance(parts, str) else parts
        hits = [e for e in kern if any(part in e.key for part in parts)]
        ms = sum(e.self_device_time_total for e in hits) / 1e3
        rows.append(f"{label} ({' + '.join(parts)}) {ms:.3f} ms x{sum(e.count for e in hits)} "
                    f"({ms / busy_ms:.1%} of busy)")
    return (f"phase {phase} profile on {smi}: {what} (kernel path, torch.profiler) "
            f"{wall_ms:.3f} ms on the host clock, kernels busy {busy_ms:.3f} ms (device idle "
            f"{max(0.0, 1 - busy_ms / wall_ms):.1%}); by self device time: " + "; ".join(rows))


def _h2d_copies(fn) -> list[str]:
    """The host-to-device copies one call of ``fn`` records under
    torch.profiler: the runtime's memcpy calls and the device's HtoD copies,
    as "name xcount"."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [f"{e.key} x{e.count}" for e in prof.key_averages()
            if "HtoD" in e.key or e.key.startswith("cudaMemcpy")]


def _counters():
    from qasr_torch.ops.kernels.dgt import dgt
    from qasr_torch.ops.kernels.qconv_dw_prep import qconv_dw_prep
    from qasr_torch.ops.kernels.qconv_dx import qconv_dx8, qconv_dx10
    from qasr_torch.ops.kernels.qconv_ft import qconv_ft8, qconv_ft10
    from qasr_torch.ops.kernels.qgemm import qgemm10, qgemm10_dw, qgemm10_dx
    from qasr_torch.ops.kernels.qgemm8 import qgemm8_cl, qgemm8_dx
    from qasr_torch.ops.kernels.qlstm_scan import qlstm_scan_bwd, qlstm_scan_fast8

    return {"qconv_ft8": qconv_ft8, "qgemm8": qgemm8_cl, "qgemm8_dx": qgemm8_dx,
            "qconv_dx8": qconv_dx8, "qlstm_scan8": qlstm_scan_fast8,
            "qlstm_scan8_bwd": qlstm_scan_bwd, "qconv_ft10": qconv_ft10,
            "qconv_dx10": qconv_dx10, "qgemm10": qgemm10, "qgemm10_dx": qgemm10_dx,
            "qgemm10_dw": qgemm10_dw, "dgt": dgt, "qconv_dw_prep": qconv_dw_prep}


def _want(**launches) -> dict:
    """Every kernel's count 0 but those given."""
    return {**{name: 0 for name in _counters()}, **launches}


def _reset_counts() -> None:
    torch.cuda.synchronize()
    for fn in _counters().values():
        fn.launches = 0


def _read_counts() -> dict:
    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in _counters().items()}


def _train_batch(tcfg) -> dict:
    """The fixed TIMIT-like batch the TIMIT models train on (main's
    training configuration): 16 utterances of 256 frames with 40 labels."""
    brng = np.random.default_rng(SEED + 1)
    return {
        "features": brng.standard_normal((16, 256, 40, 4)).astype(np.float32),
        "feature_lengths": np.full(16, 256, np.int32),
        "labels": brng.integers(1, 62, size=(16, tcfg.data.max_label_len)).astype(np.int32),
        "label_lengths": np.full(16, 40, np.int32),
        "real_rows": np.ones(16, bool),
    }


def _qlstm_train_batch(cfg):
    """Config 4's training configuration and fixed batch (phase 8): synthetic
    data (the corpus does not ship with the repo), one 512-frame bucket, a
    2-step warmup and the 1e-4 peak rate of phase 6; the preset's 32
    utterances, ragged, 128-512 frames (zero past each length, as batching
    pads), one character label per 8 frames."""
    T, B = cfg.data.bucket_sizes[0], cfg.data.batch_size
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
    return tcfg, batch


def _wg_registers(log: str) -> list[str]:
    """ptxas's registers and spill stores of each instantiation of the bf16
    wgmma loops (``qconv_wg_kernel``: A, C, F, G; ``qgemm_bf16_kernel``: B,
    H; ``dgt_wg_kernel``: J, rows and cols modes) and of the recurrence's
    kernels (``qlstm_scan8_kernel``: D, ``qlstm_scan8_bwd_kernel``: E, bf16
    and f32), from an ``nvcc -Xptxas -v`` log, as "loop<P, epilogue> N
    registers, S bytes spilled"."""
    import re

    out, name, spill = [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_ZN\w+?(qconv_wg_kernel|qgemm_bf16_kernel)"
                      r"ILi(\d+)E(?:NS_\d+(\w+?)I)?", line)
        if m:
            name = f"{m.group(1)}<{m.group(2)}{', ' + m.group(3) if m.group(3) else ''}>"
            continue
        m = re.search(r"Compiling entry function '\S*?\d(qlstm_scan8_kernel|qlstm_scan8_bwd_kernel)"
                      r"I(13__nv_bfloat16|f)E", line)
        if m:
            name = f"{m.group(1)}<{'f32' if m.group(2) == 'f' else 'bf16'}>"
            continue
        m = re.search(r"Compiling entry function '\S*?dgt_wg_kernelILb([01])E", line)
        if m:
            name = f"dgt_wg_kernel<{'rows' if m.group(1) == '1' else 'cols'}>"
            continue
        if name and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        m = re.search(r"Used (\d+) registers", line)
        if name and m:
            out.append(f"{name} {m.group(1)} registers, {spill} bytes spilled")
            name = None
    return out


def _rank8_combo(x: torch.Tensor, terms, dim: int) -> torch.Tensor:
    """A rank-8 input combo as the JAX package forms it (``_scaled``): each
    coefficient rounded to x's dtype, each scaled term rounded once, then
    the sum rounded once. Written out here, so that it holds any tree's
    kernels to the same rule."""
    out = None
    for a, c in terms:
        t = x.select(dim, a) * torch.tensor(c, dtype=x.dtype).item()
        out = t if out is None else out + t
    return out


def _combo_mismatches(dev: torch.device) -> dict:
    """The rank-8 kernels' input combos (A, C and B in bf16, of the
    ``qasr_torch`` imported) against :func:`_rank8_combo`, for each of V8's
    products: product p's weight combos are the identity (the conv's centre
    tap), the rest zero, so each output is O8[b, p] * combo_p rounded once
    to bf16. Returns, per kernel, how many of its outputs over the eight
    products differ from that."""
    from qasr_torch.ops.kernels.qconv_dx import qconv_dx_cuda
    from qasr_torch.ops.kernels.qconv_ft import _O8_F32, SCHEME8, qconv_ft_cuda
    from qasr_torch.ops.kernels.qgemm8 import qgemm8_cuda

    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    bf16, c = torch.bfloat16, 72  # past a 64-wide tile and a 32-deep chunk
    o8 = torch.from_numpy(_O8_F32).to(dev)
    # values over 2^-6 .. 2^6, both signs
    x = (torch.randn(2, 4, 5, 70, c, generator=g, device=dev)
         * 2.0 ** torch.randint(-6, 6, (2, 4, 5, 70, c), generator=g, device=dev)).to(bf16)
    x4 = x[0].reshape(4, 350, c).contiguous()
    eye = torch.eye(c, device=dev, dtype=bf16)
    bad = {"A": 0, "C": 0, "B": 0}
    for p, terms in enumerate(SCHEME8.fwd_in):
        wc = torch.zeros(8, 3, 3, c, c, device=dev, dtype=bf16)
        wc[p, 1, 1] = eye
        wc8 = torch.zeros(8, c, c, device=dev, dtype=bf16)
        wc8[p] = eye
        cx, c4 = _rank8_combo(x, terms, 1).float(), _rank8_combo(x4, terms, 0).float()
        want_x = torch.stack([o8[b, p] * cx for b in range(4)], 1).to(bf16)
        want_4 = torch.stack([o8[b, p] * c4 for b in range(4)]).to(bf16)
        for name, got, want in (("A", qconv_ft_cuda(x, wc), want_x),
                                ("C", qconv_dx_cuda(x, wc)[0], want_x),
                                ("B", qgemm8_cuda(x4, wc8), want_4)):
            bad[name] += (got != want).sum().item()
    return bad


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
    from qasr_torch.ops.kernels.qconv_ft import qconv_ft8, qconv_stacked_plain
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
                          qconv_stacked_plain(x.float(), w, bias, alpha))
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
    want = _want(qconv_ft8=2 * 3, qgemm8=2 * n_b, qlstm_scan8=2 * 3)  # two forwards
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
        prof_line = _profile(lambda: enc(feats, lengths=full),
                             f"one encoder forward B{B}xT{T}", 7, smi, 8)
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
    print(prof_line, flush=True)
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
    from qasr_torch.ops.kernels.qconv_dx import qconv_dx8, qconv_dx_plain
    from qasr_torch.ops.kernels.qconv_ft import qconv_ft8, qconv_stacked_plain
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
                ref, ref_da = qconv_dx_plain(dz.float(), w, None if zz is None else zz.float(), sl)
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
                              qconv_stacked_plain(x.float(), w, bb, aa))
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
    # synthetic data, with its fixed batch (_qlstm_train_batch)
    tcfg, batch = _qlstm_train_batch(cfg)
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
    want = _want(qconv_ft8=3, qconv_dx8=3, qgemm8=n_b, qgemm8_dx=n_b, qlstm_scan8=3,
                 qlstm_scan8_bwd=3, qconv_dw_prep=3)
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
        lcfg, dev, "smoke_train_qlstm", wavs,
        {"qlstm_scan8_bwd": 3, "qconv_dx8": 3, "qconv_dw_prep": 3})
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
    prof_line = _profile(lambda: train_step(st_k, batch),
                         f"one config 4 train step B{B}xT{T}", 8, smi, 10)
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
                              lambda: qconv_dx_plain(dz, w, zz, sl), 5)
        # dz (and z_prev) in, dx out, the weight combos (and slopes, dalpha)
        nbytes = _nbytes(dz) + (2 if i else 1) * _nbytes(dz) * cin // cout + 8 * 9 * cin * cout * 2
        bound = _bound(2 * 8 * B * nf * T * cin * cout * 9, nbytes)
        c_times.append((cin, cout, i > 0, ck, cp, bound[0]))
        del w, dz, zz
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
    print(prof_line, flush=True)
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


def _write_wavs(wavs: list, directory: str, rate: int) -> list[str]:
    """Each waveform as a 16-bit mono RIFF wav file; returns the paths."""
    import wave

    paths = []
    for i, w in enumerate(wavs):
        path = os.path.join(directory, f"utt{i}.wav")
        pcm = np.clip(np.round(w * 32768.0), -32768, 32767).astype(np.int16)
        with wave.open(path, "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(rate)
            f.writeframes(pcm.tobytes())
        paths.append(path)
    return paths


def phase9_fast10(dev: torch.device, smi: str, tcfg8, batch: dict, wavs: list) -> list[dict]:
    """``timit_qcnn`` in the 10-product scheme (``op_variant=fused``,
    ``dense_variant=pallas``) at full width, served and trained through the
    command line; ``use_pallas`` too. Returns the kernels line's entries of
    kernels F, G, H (both roles) and I."""
    import contextlib
    import io

    from qasr_torch import cli
    from qasr_torch.bridge import save_params_npz
    from qasr_torch.configs import get_config
    from qasr_torch.infer import Transcriber
    from qasr_torch.models import build_model
    from qasr_torch.ops.kernels.qconv_dx import (
        conj_transpose_w,
        qconv_dx10,
        qconv_dx10_rotated_plain,
        qconv_dx_cuda,
        qconv_dx_plain,
    )
    from qasr_torch.ops.kernels.qconv_ft import (
        SCHEME10,
        qconv_ft10,
        qconv_ft_cuda,
        qconv_stacked_plain,
    )
    from qasr_torch.ops.kernels.qgemm import (
        dw_splits,
        qgemm10,
        qgemm10_cuda,
        qgemm10_dw,
        qgemm10_dw_cuda,
        qgemm10_dx,
        qgemm_dw_plain,
        qgemm_stacked_plain,
    )
    from qasr_torch.ops.kernels.qgemm8 import conj_transpose_dense
    from qasr_torch.ops.quaternion import W_COMBO, combine_weights, hamilton_expand
    from qasr_torch.train.state import create_train_state
    from qasr_torch.train.step import train_step

    g = torch.Generator(device=dev).manual_seed(SEED + 9)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    bf16 = torch.bfloat16
    over = {"model.op_variant": "fused", "model.dense_variant": "pallas"}
    cfg = get_config("timit_qcnn").override(**over)
    tcfg = tcfg8.override(**over)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "qasr_torch", "_build",
                        "smoke_fast10")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)

    # kernels F and G at the path's shape (B16 F13 T256, 256 -> 256, 3x3);
    # H forward and dx, and I, at the dense layers' M4096 (K3328 and K256,
    # N256) and at the im2col convs' M53248 K2304 N256 (use_pallas: nine of
    # its twelve launches of each); f32 and bf16 against the plain versions,
    # gated as in phase 3: f32 differs in the summation order only; bf16
    # rounds the combos (X_COMBO x, W_COMBO w, OUT_COMBO dy) to bf16 before
    # the f32-accumulated products, as the TPU kernels do. I twice at each
    # shape: the same bits.
    B, NF, T, C = 16, 13, 256, 256
    w = rnd(4, 3, 3, C, C, scale=(1.0 / (9 * C)) ** 0.5)
    bias, alpha = rnd(4 * C, scale=0.1), rnd(4 * C, scale=0.25).abs()
    slopes = rnd(4 * C, scale=0.25)  # signed, so alpha < 0 is covered
    x32, dz32 = rnd(B, 4, NF, T, C, scale=0.5), rnd(B, 4, NF, T, C)
    err = {}
    for dtype, tol in ((torch.float32, TOL_F32), (bf16, TOL_BF16)):
        dname, x, dz = str(dtype)[6:], x32.to(dtype), dz32.to(dtype)
        shape = f"B{B} F{NF} T{T} C{C} k3x3 {dname}"
        for bb, aa in ((None, None), (bias, alpha)):
            e = _errors(qconv_ft10(x, w, bb, aa),
                        qconv_stacked_plain(x.float(), w, bb, aa, scheme=SCHEME10))
            _report(f"qconv_ft10 {shape} prologue+bias={bb is not None}", e, tol, 9)
            if dtype == bf16:
                err["qconv_ft10"] = max(err.get("qconv_ft10", 0.0), e["max_abs_err"])
        for epi in (False, True):
            zz, sl = (x, slopes) if epi else (None, None)
            dx, da = qconv_dx10(dz, w, zz, sl)
            ref, ref_da = qconv_dx_plain(dz.float(), w, None if zz is None else zz.float(), sl,
                                         scheme=SCHEME10)
            e = _errors(dx, ref)
            _report(f"qconv_dx10 {shape} epilogue={epi} dx", e, tol, 9)
            if epi:
                e_da = _errors(da, ref_da)
                _report(f"qconv_dx10 {shape} epilogue=True dalpha", e_da, tol, 9)
                again, again_da = qconv_dx10(dz, w, zz, sl)
                if not (torch.equal(again, dx) and torch.equal(again_da, da)):
                    raise RuntimeError("qconv_dx10 differs between two runs on the same inputs")
                e = {k: max(e[k], e_da[k]) for k in e}
            else:
                # the TPU's own dx formulation (rotated roles), the same function
                _report(f"qconv_dx10 {shape} dx vs the TPU's rotated roles",
                        _errors(dx, qconv_dx10_rotated_plain(dz.float(), w)), tol, 9)
            if dtype == bf16:
                err["qconv_dx10"] = max(err.get("qconv_dx10", 0.0), e["max_abs_err"])
            del dx, ref
        del x, dz
    del x32, dz32
    torch.cuda.empty_cache()
    for m, k, n in ((4096, 3328, 256), (4096, 256, 256), (53248, 2304, 256)):
        wg = rnd(4, k, n, scale=(1.0 / k) ** 0.5)
        xg32 = rnd(4, m, k, scale=0.5)
        dyg32 = rnd(4, m, n)
        for dtype, tol in ((torch.float32, TOL_F32), (bf16, TOL_BF16)):
            dname, x4, dy4 = str(dtype)[6:], xg32.to(dtype), dyg32.to(dtype)
            e = _errors(qgemm10(x4, wg), qgemm_stacked_plain(x4.float(), wg))
            _report(f"qgemm10 M{m} K{k} N{n} {dname}", e, tol, 9)
            if (k, dtype) == (3328, bf16):
                err["qgemm10"] = e["max_abs_err"]
            e = _errors(qgemm10_dx(dy4, wg),
                        qgemm_stacked_plain(dy4.float(), conj_transpose_dense(wg)))
            _report(f"qgemm10_dx M{m} N{n} -> K{k} {dname}", e, tol, 9)
            if (k, dtype) == (3328, bf16):
                err["qgemm10_dx"] = e["max_abs_err"]
            got = qgemm10_dw(x4, dy4)
            if not torch.equal(got, qgemm10_dw(x4, dy4)):
                raise RuntimeError(f"qgemm10_dw M{m} K{k} {dname} differs between two runs on "
                                   f"the same inputs")
            e = _errors(got, qgemm_dw_plain(x4, dy4))
            _report(f"qgemm10_dw M{m} K{k} N{n} {dname}", e, tol, 9)
            if (k, dtype) == (3328, bf16):
                err["qgemm10_dw"] = e["max_abs_err"]
            del x4, dy4, got
            torch.cuda.empty_cache()
        del xg32, dyg32
    torch.cuda.empty_cache()

    # the serving path through the command line: a checkpoint whose
    # config.json names the 10-product routing, four written wav files,
    # `python -m qasr_torch.cli transcribe` in a fresh process, then
    # transcribe_main in this one, greedy and beam, with its launches
    model = build_model(cfg, generator=torch.Generator().manual_seed(SEED), device=dev)
    if (model.conv_scheme, sum(model.stacked), model.dense_scheme) != ("fast10", 9, "fast10"):
        raise RuntimeError(f"10-product routing: {model.conv_scheme} {model.stacked} "
                           f"{model.dense_scheme}")
    ckpt = os.path.join(root, "serve")
    os.makedirs(ckpt)
    save_params_npz(model.state_dict(), os.path.join(ckpt, "params.npz"))
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        f.write(cfg.to_json())
    del model
    paths = _write_wavs(wavs, root, cfg.data.sample_rate)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "qasr_torch.cli", "transcribe", "--ckpt", ckpt, *paths],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    cli_s = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    if proc.returncode != 0 or [ln.split("\t")[0] for ln in lines] != paths:
        raise RuntimeError(f"python -m qasr_torch.cli transcribe: rc {proc.returncode}\n"
                           f"{proc.stdout}\n{proc.stderr[-3000:]}")
    _reset_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        hyp_greedy = cli.transcribe_main(["--ckpt", ckpt, *paths])
        hyp_beam = cli.transcribe_main(["--ckpt", ckpt, "--beam", *paths])
    counts = _read_counts()
    n_fwd = 2 * len(paths)  # one forward a file, greedy and beam
    if counts != _want(qconv_ft10=9 * n_fwd, qgemm10=3 * n_fwd):
        raise RuntimeError(f"10-product serving launches {counts}, expected F 9 and H 3 a "
                           f"forward over {n_fwd} forwards")
    if not all(isinstance(p, str) for h in hyp_greedy + hyp_beam for p in h):
        raise RuntimeError("10-product serving did not return phone strings")
    served = Transcriber(ckpt, device=dev)
    logits, lengths = served.logits(wavs)
    logits_plain, _ = served.logits(wavs, plain=True)
    cfg32 = cfg.override(**{"model.compute_dtype": "float32"})
    logits_f32, _ = Transcriber(ckpt, cfg=cfg32, device=dev).logits(wavs, plain=True)
    torch.cuda.synchronize()
    # the error model of phase 4's limits: 13 layer boundaries rounding to
    # bf16, the schemes' combos rounding alike
    lerr = _errors(logits, logits_plain)
    _gate("10-product serving logits kernel vs plain", lerr, TOL_LOGITS)
    kerr32 = _errors(logits, logits_f32)
    _gate("10-product serving logits kernel vs f32 plain", kerr32, TOL_LOGITS_F32)
    perr32 = _errors(logits_plain, logits_f32)
    _gate("10-product serving logits plain bf16 vs f32 plain", perr32, TOL_LOGITS_F32)
    print(f"phase 9 serving: timit_qcnn op_variant=fused dense_variant=pallas bf16 through "
          f"the CLI; `python -m qasr_torch.cli transcribe` rc 0 in {cli_s:.1f} s, {len(lines)} "
          f"lines; transcribe_main greedy and beam: launches per forward qconv_ft10 "
          f"{counts['qconv_ft10'] // n_fwd} qgemm10 {counts['qgemm10'] // n_fwd}; greedy phones "
          f"{[len(h) for h in hyp_greedy]}, beam phones {[len(h) for h in hyp_beam]}; logits "
          f"{tuple(logits.shape)} kernel vs plain rel_norm {lerr['rel_norm']:.3e} (tol "
          f"{TOL_LOGITS}); against the f32 plain path: kernel {kerr32['rel_norm']:.3e}, bf16 "
          f"plain {perr32['rel_norm']:.3e} (tol {TOL_LOGITS_F32})", flush=True)
    del served, logits, logits_plain, logits_f32
    torch.cuda.empty_cache()

    # training: gradient parity (phase 6's error model and limits: the
    # schemes round at the same boundaries), launches of one step, twenty
    # steps on the fixed batch
    _grad_parity(tcfg, batch, dev, 9, "fast10: ")
    state = create_train_state(tcfg, device=dev)
    _reset_counts()
    losses = [train_step(state, batch)["loss"].item()]
    step_counts = _read_counts()
    want = _want(qconv_ft10=9, qconv_dx10=9, qgemm10=3, qgemm10_dx=3, qgemm10_dw=3,
                 qconv_dw_prep=9)
    if step_counts != want:
        raise RuntimeError(f"10-product launches in one train step {step_counts}, expected {want}")
    for _ in range(19):
        losses.append(train_step(state, batch)["loss"].item())
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise RuntimeError(f"fast10: twenty steps on one batch did not lower the loss: {losses}")
    del state
    torch.cuda.empty_cache()
    print(f"phase 9 train steps: launches per step F {step_counts['qconv_ft10']} G "
          f"{step_counts['qconv_dx10']} H {step_counts['qgemm10']} + "
          f"{step_counts['qgemm10_dx']} I {step_counts['qgemm10_dw']}; loss over 20 steps on "
          f"one batch {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)

    # the main path: `main` of the CLI trains 4 steps (an eval over the
    # synthetic set, a checkpoint), transcribe_main serves its checkpoint
    n_steps = 4
    sets = [f"{k}={v}" for k, v in {
        "data.dataset": "synthetic", "data.n_mels": 40, "model.vocab": 62,
        "data.bucket_sizes": "256", "train.warmup_steps": 2, "train.learning_rate": 1e-4,
        "train.num_steps": n_steps, "train.log_every": 2, "train.eval_every": n_steps,
        "train.checkpoint_every": n_steps, "train.checkpoint_dir": os.path.join(root, "train"),
        **over}.items()]
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        last = cli.main(["--preset", "timit_qcnn", "--set", *sets])
    train_s = time.perf_counter() - t0
    train_counts = _read_counts()
    n_eval = train_counts["qconv_ft10"] // 9 - n_steps
    want = _want(qconv_ft10=9 * (n_steps + n_eval), qconv_dx10=9 * n_steps,
                 qgemm10=3 * (n_steps + n_eval), qgemm10_dx=3 * n_steps, qgemm10_dw=3 * n_steps,
                 qconv_dw_prep=9 * n_steps)
    if train_counts != want or n_eval < 1 or not math.isfinite(last["loss"]):
        raise RuntimeError(f"the CLI's train run: launches {train_counts}, expected {want} "
                           f"({n_eval} eval forwards); last log {last}")
    with contextlib.redirect_stdout(io.StringIO()):
        hyp = cli.transcribe_main(["--ckpt", os.path.join(root, "train"), *paths[:2]])
    if len(hyp) != 2:
        raise RuntimeError("the CLI's checkpoint did not serve")
    print(f"phase 9 train (CLI): timit_qcnn 10-product full width, {n_steps} steps and "
          f"{n_eval} eval forwards in {train_s:.2f} s, last log "
          f"{json.dumps({k: last[k] for k in sorted(last)})}; launches {train_counts}; "
          f"transcribe_main served its checkpoint (phones {[len(h) for h in hyp]})", flush=True)

    # use_pallas: every conv packed (conv 1 -> 256 on the block path, the
    # nine 256 -> 256 on slice-im2col and kernel H), every dense layer on H;
    # launches of one forward and one train step; gradient parity on four
    # of the batch's utterances (the plain path's f32 im2col products at
    # B16 would hold ~60 GB)
    pcfg = tcfg.override(**{"model.use_pallas": True})
    pmodel = build_model(pcfg, generator=torch.Generator().manual_seed(SEED), device=dev)
    if pmodel.conv_scheme is not None or sum(getattr(pmodel, f"qconv_{i}").im2col
                                             for i in range(10)) != 9:
        raise RuntimeError("use_pallas routing")
    feats = torch.as_tensor(batch["features"], device=dev)
    _reset_counts()
    with torch.no_grad():
        pmodel(feats)
    p_fwd = _read_counts()
    del pmodel
    pstate = create_train_state(pcfg, device=dev)
    _reset_counts()
    p_loss = train_step(pstate, batch)["loss"].item()
    p_step = _read_counts()
    del pstate
    torch.cuda.empty_cache()
    if p_fwd != _want(qgemm10=12) or p_step != _want(qgemm10=12, qgemm10_dx=12, qgemm10_dw=12):
        raise RuntimeError(f"use_pallas launches: forward {p_fwd}, step {p_step}")
    small = {k: v[:4] for k, v in batch.items()}
    _grad_parity(pcfg, small, dev, 9, "use_pallas B4: ")
    print(f"phase 9 use_pallas: launches per forward H {p_fwd['qgemm10']}, per train step H "
          f"{p_step['qgemm10']} + {p_step['qgemm10_dx']} I {p_step['qgemm10_dw']} (9 im2col "
          f"convs at M {B * T * NF} K {9 * C}, 3 dense layers); step loss {p_loss:.4f}",
          flush=True)

    # timing (not gated): the encoder forward and the train step in the
    # 10-product scheme against the rank-8 one on the same weights
    m10 = build_model(cfg, generator=torch.Generator().manual_seed(SEED), device=dev)
    m8 = build_model(get_config("timit_qcnn"), device=dev)
    m8.load_state_dict(m10.state_dict())
    audio_s = B * T * FRAME_S
    with torch.no_grad():
        fwd10, fwd8 = _alternating(lambda: m10(feats), lambda: m8(feats), 3)
    del m10, m8
    st10 = create_train_state(tcfg, device=dev)
    st8 = create_train_state(tcfg8, device=dev)
    step10, step8 = _alternating(lambda: train_step(st10, batch), lambda: train_step(st8, batch), 3)
    # kernel G with its dalpha pass; kernel I: its split-M pass and, where S
    # > 1, the second pass that sums the runs (qtile's reduce_splits; no
    # other kernel of the step runs it)
    named = {"kernel F": "qconv_wg_kernel<10, qconv::BiasStore",
             "kernel G": ("qconv_wg_kernel<10, qconv::PreluBwdStore", "dalpha_reduce_kernel"),
             "kernel H": "qgemm_bf16_kernel<10",
             "kernel I": ("qgemm10_dw_kernel<", "reduce_splits_kernel<float>")}
    prof_line = _profile(lambda: train_step(st10, batch),
                         f"one 10-product config 2 train step B{B}xT{T}", 9, smi, 10, named)
    del st10, st8
    torch.cuda.empty_cache()
    # the use_pallas step, where kernel I weighs most (nine im2col dW at
    # M53248 K2304): after a warm-up, CUDA events
    stp = create_train_state(pcfg, device=dev)
    step_pallas = _time_ms(lambda: train_step(stp, batch), 3, 2)
    del stp
    torch.cuda.empty_cache()

    # each kernel at its path shape (bf16), on CUDA events: the wrapper's
    # call (its weight combos and casts included, as the step runs it) and
    # the launcher alone on inputs made ready beforehand, against its plain
    # version, its bound and one library call
    t = {}
    with torch.no_grad():
        xa = rnd(B, 4, NF, T, C, scale=0.5).to(bf16)
        dza = rnd(B, 4, NF, T, C).to(bf16)
        wa = rnd(4, 3, 3, C, C, scale=0.02)
        # the library calls: one F.conv2d on the Hamilton-expanded (adjoint)
        # weight over the packed NCHW input
        xa_lib = xa.permute(0, 1, 4, 2, 3).reshape(B, 4 * C, NF, T).contiguous()
        dza_lib = dza.permute(0, 1, 4, 2, 3).reshape(B, 4 * C, NF, T).contiguous()
        wf_lib = hamilton_expand(wa).permute(3, 2, 1, 0).contiguous().to(bf16)
        wg_lib = hamilton_expand(conj_transpose_w(wa)).permute(3, 2, 1, 0).contiguous().to(bf16)
        wc_f = combine_weights(wa, bf16, SCHEME10.u).contiguous()
        wc_g = combine_weights(conj_transpose_w(wa), bf16, SCHEME10.u).contiguous()
        fl_conv = 2 * 10 * B * NF * T * 9 * C * C
        t["qconv_ft10"] = (
            *_alternating(lambda: qconv_ft10(xa, wa, bias, alpha),
                          lambda: qconv_stacked_plain(xa, wa, bias, alpha, scheme=SCHEME10), 5),
            _time_ms(lambda: F.conv2d(xa_lib, wf_lib, padding=1), 5),
            _bound(fl_conv, 2 * _nbytes(xa) + 10 * 9 * C * C * 2 + _nbytes(bias, alpha)),
            _time_ms(lambda: qconv_ft_cuda(xa, wc_f, bias, alpha, scheme=SCHEME10), 5))
        t["qconv_dx10"] = (
            *_alternating(lambda: qconv_dx10(dza, wa, xa, slopes),
                          lambda: qconv_dx_plain(dza, wa, xa, slopes, scheme=SCHEME10), 5),
            _time_ms(lambda: F.conv2d(dza_lib, wg_lib, padding=1), 5),
            _bound(fl_conv, 3 * _nbytes(dza) + 10 * 9 * C * C * 2 + 2 * _nbytes(slopes)),
            _time_ms(lambda: qconv_dx_cuda(dza, wc_g, xa, slopes, scheme=SCHEME10), 5))
        del xa, dza, xa_lib, dza_lib, wc_f, wc_g
        torch.cuda.empty_cache()
        gemm_rows = []
        for m, k, n in ((4096, 3328, 256), (4096, 256, 256), (53248, 2304, 256)):
            xg = rnd(4, m, k, scale=0.5).to(bf16)
            wg = rnd(4, k, n, scale=k ** -0.5)
            dyg = rnd(4, m, n).to(bf16)
            wt = conj_transpose_dense(wg)
            reps = 3 if m > 4096 else 10
            fl = 2 * 10 * m * k * n
            xg_lib = xg.permute(1, 0, 2).reshape(m, 4 * k).contiguous()
            dy_lib = dyg.permute(1, 0, 2).reshape(m, 4 * n).contiguous()
            w_lib = hamilton_expand(wg).to(bf16)
            wt_lib = hamilton_expand(wt).to(bf16)
            xt_lib = xg_lib.t()
            wc_h = combine_weights(wg, bf16, W_COMBO).contiguous()
            wc_ht = combine_weights(wt, bf16, W_COMBO).contiguous()
            row = {"m": m, "k": k, "n": n}
            for key, call, plain, lib_call, nbytes, launch in (
                ("fwd", lambda: qgemm10(xg, wg), lambda: qgemm_stacked_plain(xg, wg),
                 lambda: torch.matmul(xg_lib, w_lib),
                 _nbytes(xg) + 10 * k * n * 2 + _nbytes(dyg), lambda: qgemm10_cuda(xg, wc_h)),
                ("dx", lambda: qgemm10_dx(dyg, wg), lambda: qgemm_stacked_plain(dyg, wt),
                 lambda: torch.matmul(dy_lib, wt_lib),
                 _nbytes(dyg) + 10 * k * n * 2 + _nbytes(xg),
                 lambda: qgemm10_cuda(dyg, wc_ht, role="dx")),
                ("dw", lambda: qgemm10_dw(xg, dyg), lambda: qgemm_dw_plain(xg, dyg),
                 lambda: torch.matmul(xt_lib, dy_lib),
                 _nbytes(xg, dyg) + 4 * k * n * 4, lambda: qgemm10_dw_cuda(xg, dyg)),
            ):
                row[key] = (*_alternating(call, plain, reps), _time_ms(lib_call, reps),
                            _bound(fl, nbytes), _time_ms(launch, reps))
            gemm_rows.append(row)
            del xg, dyg, xg_lib, dy_lib, xt_lib
            torch.cuda.empty_cache()
    train_audio_s = float(np.sum(batch["feature_lengths"])) * FRAME_S
    print(f"phase 9 timing on {smi}: encoder fwd B{B}xT{T} 10-product {fwd10:.3f} ms "
          f"({audio_s / fwd10 * 1e3:.1f} audio-s/s), rank-8 {fwd8:.3f} ms; train step 10-product "
          f"{step10:.3f} ms ({train_audio_s / step10 * 1e3:.1f} audio-s/s), rank-8 {step8:.3f} ms "
          f"({train_audio_s / step8 * 1e3:.1f} audio-s/s), use_pallas {step_pallas:.3f} ms "
          f"({train_audio_s / step_pallas * 1e3:.1f} audio-s/s)", flush=True)

    def fmt(name, v):
        return (f"{name} call {v[0]:.4f} ms (the launcher alone {v[4]:.4f} ms) "
                f"plain {v[1]:.4f} ms library {v[2]:.4f} ms bound {v[3][0]:.4f} ms ({v[3][1]})")

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"phase 9 timing on {smi}: " + "; ".join(
        [fmt(f"{name} B{B} F{NF} T{T} C{C}", t[name]) for name in ("qconv_ft10", "qconv_dx10")]
        + [fmt(f"{role} M{r['m']} K{r['k']} N{r['n']}"
               + (f" S{dw_splits(r['m'], r['k'], r['n'], bf16, sms)}" if key == "dw" else ""),
               r[key])
           for r in gemm_rows for key, role in (("fwd", "qgemm10"), ("dx", "qgemm10_dx"),
                                                ("dw", "qgemm10_dw"))]),
          flush=True)
    print(prof_line, flush=True)
    shutil.rmtree(root, ignore_errors=True)

    dense = gemm_rows[0]
    timed = {**t, "qgemm10": dense["fwd"], "qgemm10_dx": dense["dx"], "qgemm10_dw": dense["dw"]}
    replaces = {
        "qconv_ft10": ("qasr_torch/csrc/qconv_ft10.cu",
                       "qasr/ops/pallas/qconv_ft.py:120 (_ft_kernel, SCHEME10, fwd); "
                       "qasr/ops/pallas/qconv_chain.py:118 (fast10)"),
        "qconv_dx10": ("qasr_torch/csrc/qconv_dx10.cu",
                       "qasr/ops/pallas/qconv_ft.py:120 (_ft_kernel, SCHEME10, dx role); "
                       "qasr/ops/pallas/qconv_chain.py:254 (fast10)"),
        "qgemm10": ("qasr_torch/csrc/qgemm10.cu", "qasr/ops/pallas/qgemm.py:67 (_qgemm_kernel)"),
        "qgemm10_dx": ("qasr_torch/csrc/qgemm10.cu",
                       "qasr/ops/pallas/qgemm.py:67 (_qgemm_kernel on _conj_transpose_w, dx)"),
        "qgemm10_dw": ("qasr_torch/csrc/qgemm10_dw.cu",
                       "qasr/ops/pallas/qgemm.py:164 (_qgemm_dw_kernel)"),
    }
    return [{"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": train_counts[name], "max_abs_err": err[name], "ms": timed[name][0],
             "plain_ms": timed[name][1], "bound_ms": timed[name][3][0],
             "bound_by": timed[name][3][1], "library_ms": timed[name][2]}
            for name, (src, rep) in replaces.items()]


def phase10_dgt_real_cnn(dev: torch.device, smi: str, tcfg8, batch: dict, wavs: list) -> dict:
    """Kernel J and the real-CNN baseline. Kernel J (the row-contracting
    ``x^T y`` of ``benchmarks/probe_dgt.py``) against its plain version at
    the probe's shape and a ragged one, both modes, f32 and bf16, the same
    bits across modes and runs (gated); its main path, ``qasr_torch.tools.probe_dgt``, in this
    process with its launches counted and once as a subprocess. Config 3,
    ``timit_real_cnn``, at full width: served greedy and beam, twenty steps,
    one ``train()`` whose checkpoint serves (gated; it launches none of the
    port's kernels). Then, not gated: its train step against the rank-8
    QCNN's (``vs_baseline``) and a torch.profiler breakdown of one of its
    steps, ``conv_roofline`` on the block path and under
    ``use_pallas``, and kernel J's time against its plain version, its bound
    and ``torch.matmul``, on CUDA events and in CUDA-graph replays. Returns
    kernel J's entry of the kernels line."""
    from qasr_torch.configs import get_config
    from qasr_torch.infer import Transcriber
    from qasr_torch.models import build_model
    from qasr_torch.models.qcnn import RealCNNEncoder
    from qasr_torch.ops.kernels.dgt import dgt, dgt_plain
    from qasr_torch.tools import probe_dgt
    from qasr_torch.train.state import create_train_state
    from qasr_torch.train.step import train_step
    from qasr_torch.utils.profiling import conv_roofline

    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    m, k, n = probe_dgt.M, probe_dgt.K, probe_dgt.N

    # kernel J at the probe's shape, and at a ragged one (M past a chunk, K
    # and N over partial tiles), against its plain version, gated as in
    # phase 3: f32 differs in the summation order only (65536 terms a sum);
    # bf16 sums the exact products in f32 as the plain version does and
    # rounds once at the end (held against the f32 plain result, so the
    # rounding, ~2e-3 relative, is what shows). The two modes feed the
    # tensor cores (bf16) or the CUDA cores (f32) the same operands in the
    # same order: the same bits; and the split of M is summed in fixed
    # order: the same bits twice.
    j_err = None
    for mm, kk, nn in ((m, k, n), (m + 40, 264, 136)):
        x32 = torch.randn((mm, kk), generator=g, device=dev)
        y32 = torch.randn((mm, nn), generator=g, device=dev)
        for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
            x, y = x32.to(dtype), y32.to(dtype)
            x_t = x.T.contiguous()
            dname = str(dtype)[6:]
            ref = dgt_plain(x.float(), y.float(), mode="dgt")
            got = dgt(x, y, mode="dgt")
            for mode, xx in (("dgt", x), ("plain", x_t)):
                out = dgt(xx, y, mode=mode)
                err = _errors(out, ref)
                _report(f"dgt M{mm} K{kk} N{nn} {dname} mode={mode}", err, tol, phase=10)
                if not torch.equal(out, got):
                    raise RuntimeError(f"dgt M{mm} K{kk} N{nn} {dname}: mode {mode} differs in "
                                       f"bits from mode dgt")
                if (dtype, mode, mm) == (torch.bfloat16, "dgt", m):
                    j_err = err["max_abs_err"]
            if not torch.equal(dgt(x, y, mode="dgt"), got):
                raise RuntimeError(f"dgt M{mm} K{kk} N{nn} {dname} differs between two runs on "
                                   f"the same inputs")
        del x32, y32, x, y, x_t
    print(f"phase 10 parity dgt: the two modes and two runs give the same bits (f32, bf16; "
          f"M{m} K{k} N{n} and M{m + 40} K264 N136)", flush=True)

    # kernel J's main path: the probe, in this process (its launches counted)
    # and as a user runs it
    _reset_counts()
    probe_dgt.main()
    probe_counts = _read_counts()
    if probe_counts["dgt"] < 1 or probe_counts != _want(dgt=probe_counts["dgt"]):
        raise RuntimeError(f"the probe's launches {probe_counts}, expected kernel J's alone")
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run([sys.executable, "-m", "qasr_torch.tools.probe_dgt"], cwd=root,
                          env=env, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"python -m qasr_torch.tools.probe_dgt exited {proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}")
    print("phase 10 probe (python -m qasr_torch.tools.probe_dgt): "
          + " | ".join(proc.stdout.strip().splitlines()), flush=True)

    # config 3 at full width: serving, gated (finite logits of the padded
    # shape; bf16 against the same weights in f32 within phase 4's limit:
    # both paths round at ~14 layer boundaries, ~4e-3 each)
    cfg = get_config("timit_real_cnn")
    model = build_model(cfg, generator=torch.Generator().manual_seed(SEED), device=dev)
    if not isinstance(model, RealCNNEncoder):
        raise RuntimeError(f"timit_real_cnn built {type(model).__name__}")
    n_params = sum(p.numel() for p in model.parameters())
    params = model.state_dict()
    del model
    greedy = Transcriber(cfg=cfg, params=params, device=dev)
    beam = Transcriber(cfg=cfg, params=params, device=dev, beam=True)
    _reset_counts()
    hyp_greedy = greedy.transcribe_batch(wavs)
    hyp_beam = beam.transcribe_batch(wavs)
    logits, lengths = greedy.logits(wavs)
    serve_counts = _read_counts()
    if serve_counts != _want():
        raise RuntimeError(f"real-CNN serving launched port kernels: {serve_counts}")
    cfg32 = cfg.override(**{"model.compute_dtype": "float32"})
    logits32, _ = Transcriber(cfg=cfg32, params=params, device=dev).logits(wavs)
    torch.cuda.synchronize()
    want_shape = (len(wavs), logits32.shape[1], cfg.model.vocab)
    if tuple(logits.shape) != want_shape or not len(hyp_greedy) == len(hyp_beam) == len(wavs):
        raise RuntimeError(f"real-CNN logits {tuple(logits.shape)}, expected {want_shape}")
    lerr = _errors(logits, logits32)
    _gate("real-CNN serving logits bf16 vs f32", lerr, TOL_LOGITS_F32)
    del beam, params
    print(f"phase 10 serving: timit_real_cnn bf16 ({n_params / 1e6:.1f} M params), "
          f"{len(wavs)} utterances, logits {tuple(logits.shape)} finite; greedy phones "
          f"{[len(h) for h in hyp_greedy]}, beam phones {[len(h) for h in hyp_beam]}; "
          f"logits bf16 vs f32 max_abs {lerr['max_abs_err']:.3e} rel_norm "
          f"{lerr['rel_norm']:.3e} (tol {TOL_LOGITS_F32}); port kernels launched: none",
          flush=True)

    # config 3 training: phase 6's batch and schedule (peak 1e-4 after a
    # 2-step warmup); twenty steps lower the loss; one train() whose
    # checkpoint a Transcriber serves; no port kernel runs
    tcfg = cfg.override(**TRAIN_OVERRIDES)
    state = create_train_state(tcfg, device=dev)
    _reset_counts()
    losses = [train_step(state, batch)["loss"].item() for _ in range(20)]
    if _read_counts() != _want():
        raise RuntimeError("the real-CNN train step launched port kernels")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise RuntimeError(f"real CNN: twenty steps on one batch did not lower the loss: {losses}")
    del state
    torch.cuda.empty_cache()
    lcfg = tcfg.override(**{"train.num_steps": 4, "train.log_every": 2, "train.eval_every": 4,
                            "train.checkpoint_every": 4})
    last, train_counts, hyp, train_s = _train_and_serve(lcfg, dev, "smoke_real_cnn", wavs, {})
    if train_counts != _want():
        raise RuntimeError(f"real-CNN train() launched port kernels: {train_counts}")
    print(f"phase 10 train: timit_real_cnn full width, loss over 20 steps on one batch "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; train() {lcfg.train.num_steps} steps in "
          f"{train_s:.2f} s, last log {json.dumps({k: last[k] for k in sorted(last)})}; "
          f"checkpoint served {len(hyp)} utterances", flush=True)

    # not gated: the real CNN's step against the rank-8 QCNN's, in turns
    # (bench.py's vs_baseline: QCNN audio-s/s over real-CNN audio-s/s)
    audio_s = batch["features"].shape[0] * batch["features"].shape[1] * FRAME_S
    st_r = create_train_state(tcfg, device=dev)
    st_q = create_train_state(tcfg8, device=dev)
    step_r, step_q = _alternating(lambda: train_step(st_r, batch), lambda: train_step(st_q, batch),
                                  3)
    prof_r = _profile(lambda: train_step(st_r, batch), "real-CNN train step B16xT256 bf16", 10,
                      smi, 8)
    del st_r, st_q
    torch.cuda.empty_cache()
    # conv_roofline at the flagship's post-pool shape, block path and im2col
    roof = {arm: conv_roofline(batch=16, t=256, f=13, cin=256, cout=256, use_pallas=arm == "pallas",
                               device=dev)
            for arm in ("block", "pallas")}
    # on the card the chains' difference quotients are device times: gated
    # positive here (on a loaded host they can fall to zero or below, so the
    # CPU test checks only that they are finite)
    for arm, r in roof.items():
        if not (r["qconv_s"] > 0 and r["expanded_real_s"] > 0):
            raise RuntimeError(f"conv_roofline {arm}: non-positive time {r}")
    # kernel J at the probe's shape: its call against the plain version, the
    # plain mode, torch.matmul and the bound
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    y = torch.randn((m, n), generator=g, device=dev).to(torch.bfloat16)
    x_t = x.T.contiguous()
    j_ms, j_plain = _alternating(lambda: dgt(x, y, mode="dgt"),
                                 lambda: dgt_plain(x, y, mode="dgt"), 50)
    j_mode_plain = _time_ms(lambda: dgt(x_t, y, mode="plain"), 50)
    lib_j = _time_ms(lambda: torch.matmul(x.T, y), 50)
    # and in CUDA-graph replays (the host's launch cost out), beside the library
    j_graph = {"dgt": _graph_ms(lambda: dgt(x, y, mode="dgt"), 30),
               "plain": _graph_ms(lambda: dgt(x_t, y, mode="plain"), 30),
               "torch.matmul(x.T, y)": _graph_ms(lambda: torch.matmul(x.T, y), 30)}
    bound_j = _bound(2 * m * k * n, _nbytes(x, y) + k * n * x.element_size())
    print(f"phase 10 timing on {smi}: train step B16xT256 bf16 real CNN {step_r:.3f} ms "
          f"({audio_s / step_r * 1e3:.1f} audio-s/s), rank-8 QCNN {step_q:.3f} ms "
          f"({audio_s / step_q * 1e3:.1f} audio-s/s), vs_baseline {step_r / step_q:.3f}; "
          + "; ".join(f"conv_roofline {arm} B16 T256 F13 C256: qconv {r['qconv_s'] * 1e3:.3f} ms "
                      f"({r['qconv_tflops']:.1f} TFLOP/s, {r['qconv_pct_of_peak']:.1f}% of peak), "
                      f"expanded real {r['expanded_real_s'] * 1e3:.3f} ms "
                      f"({r['expanded_real_tflops']:.1f} TFLOP/s), ratio "
                      f"{r['qconv_vs_expanded_real']:.3f}" for arm, r in roof.items())
          + f"; dgt M{m} K{k} N{n} bf16 mode dgt {j_ms:.4f} ms, mode plain {j_mode_plain:.4f} "
          f"ms, plain version {j_plain:.4f} ms, torch.matmul(x.T, y) {lib_j:.4f} ms, bound "
          f"{bound_j[0]:.4f} ms ({bound_j[1]}); in CUDA-graph replays "
          + ", ".join(f"{arm} {t:.5f} ms" for arm, t in j_graph.items()), flush=True)
    print(prof_r, flush=True)
    return {"name": "dgt", "route": "cuda", "source": "qasr_torch/csrc/dgt.cu",
            "replaces": "benchmarks/probe_dgt.py:23", "launches": probe_counts["dgt"],
            "max_abs_err": j_err, "ms": j_ms, "plain_ms": j_plain, "bound_ms": bound_j[0],
            "bound_by": bound_j[1], "library_ms": lib_j}


def _batch_key(batch: dict) -> str:
    """A fingerprint of a batch: the sha1 of its arrays' bytes."""
    import hashlib

    h = hashlib.sha1()
    for k in sorted(batch):
        h.update(k.encode() + np.ascontiguousarray(batch[k]).tobytes())
    return h.hexdigest()[:16]


def phase11_corpus(dev: torch.device, smi: str, tcfg8, batch: dict) -> None:
    """The corpus path: mini-TIMIT written by the port's writer, featurized on
    the card and cached, config 2 (``timit_qcnn``, QCNN-256 bf16) trained
    through ``python -m qasr_torch.cli``'s ``main`` with dev-split evals and
    checkpoints, resumed, evaluated alone and served; config 4
    (``librispeech_qlstm``) trained on mini-LibriSpeech in streaming mode.
    Gated: the cache built once and read after, the eval set being the dev
    split, launches per step and per eval forward, the resumed run's batches,
    data states and losses against the uninterrupted run's, ``best.json``,
    ``--eval-only`` against the logged ``dev_per``, the transcribe's exit
    code, the checkpoint of config 4 serving, and streaming features against
    a cached build. Then, not gated: featurization rates, the loop's
    audio-s/s, the dev eval's seconds and the idle share of a corpus step
    against the synthetic one."""
    import contextlib
    import io

    from qasr_torch import cli
    from qasr_torch.configs import get_config
    from qasr_torch.data.batching import BatchStream, Prefetcher, epoch_iterator
    from qasr_torch.data.pipeline import LibriFeaturePipeline, TimitFeaturePipeline
    from qasr_torch.data.timit import TimitDataset
    from qasr_torch.infer import Transcriber
    from qasr_torch.models import build_model
    from qasr_torch.tools import make_mini_librispeech, make_mini_timit
    from qasr_torch.train import loop
    from qasr_torch.train.checkpoint import CheckpointManager
    from qasr_torch.train.state import create_train_state
    from qasr_torch.train.step import train_step

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(repo, "qasr_torch", "_build", "smoke_corpus")
    shutil.rmtree(root, ignore_errors=True)
    timit = os.path.join(root, "timit")
    written = make_mini_timit.write_corpus(timit, train_speakers=12, utts_per_speaker=8,
                                           dev_speakers=8, test_speakers=8, seed=SEED)
    cache_dir = os.path.join(timit, ".qasr_cache")

    # the loop's train steps and evals, seen from outside: each batch's
    # fingerprint, and the set each eval ran on; a run is interrupted (as by
    # a crash) when it comes to the step after `stop_after`
    seen = {"batches": [], "evals": [], "stop_after": None}
    real_step, real_eval = loop.train_step, loop.evaluate

    class Interrupted(Exception):
        pass

    def recording_step(state, b, **kw):
        if len(seen["batches"]) == seen["stop_after"]:
            raise Interrupted
        seen["batches"].append(_batch_key(b))
        return real_step(state, b, **kw)

    def recording_eval(cfg_, model, dataset, **kw):
        seen["evals"].append((getattr(getattr(dataset, "corpus", None), "split", None),
                              len(dataset)))
        return real_eval(cfg_, model, dataset, **kw)

    def run_cli(ckpt, n_steps, *flags):
        sets = [f"{k}={v}" for k, v in {
            "data.data_dir": timit, "train.warmup_steps": 2, "train.learning_rate": 1e-4,
            "train.num_steps": n_steps, "train.log_every": 1, "train.eval_every": 4,
            "train.checkpoint_every": 4, "train.checkpoint_dir": ckpt}.items()]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            last = cli.main(["--preset", "timit_qcnn", *flags, "--set", *sets])
        return last, out.getvalue()

    def losses(ckpt):
        with open(os.path.join(ckpt, "metrics.jsonl")) as f:
            rows = [json.loads(x) for x in f]
        return {r["step"]: r for r in rows if "loss" in r}

    cfg = get_config("timit_qcnn").override(**{"data.data_dir": timit})
    whole, split = os.path.join(root, "whole"), os.path.join(root, "split")
    loop.train_step, loop.evaluate = recording_step, recording_eval
    try:
        # the main path: 8 steps, an eval and a checkpoint every 4
        _reset_counts()
        t0 = time.perf_counter()
        last_w, _ = run_cli(whole, 8)
        whole_s = time.perf_counter() - t0
        counts = _read_counts()
        batches_w, evals_w = seen["batches"][:], seen["evals"][:]
        caches = sorted(os.listdir(cache_dir))
        mtimes = [os.path.getmtime(os.path.join(cache_dir, c)) for c in caches]
        # the same 8-step run interrupted after its step-4 checkpoint (the
        # learning-rate schedule spans num_steps, so the run to resume is
        # configured for 8), then --resume to 8, in a second directory
        seen["batches"].clear()
        seen["evals"].clear()
        seen["stop_after"] = 4
        try:
            run_cli(split, 8)
            raise RuntimeError("the run to interrupt was not interrupted")
        except Interrupted:
            pass
        seen["stop_after"] = None
        last_s, out_s = run_cli(split, 8, "--resume")
        batches_s, evals_s = seen["batches"][:], seen["evals"][:]
    finally:
        loop.train_step, loop.evaluate = real_step, real_eval

    # the cache: built once by the first run (train and dev), read after
    dev_pipe = TimitFeaturePipeline(cfg, "dev", device=dev)
    if (len(caches) != 2 or not dev_pipe.cache_hit or sorted(os.listdir(cache_dir)) != caches
            or [os.path.getmtime(os.path.join(cache_dir, c)) for c in caches] != mtimes):
        raise RuntimeError(f"the feature cache was not built once and reused: {caches}")
    # the eval set is the dev split of the corpus written
    n_dev = len(TimitDataset(timit, "dev"))
    if n_dev != written["dev"] or evals_w != [("dev", n_dev)] * 2 or evals_s != evals_w:
        raise RuntimeError(f"evals ran on {evals_w} / {evals_s}, expected the dev split's "
                           f"{written['dev']} utterances twice")
    n_eval = len(list(epoch_iterator(dev_pipe, cfg.data, train=False)))
    want = _want(qconv_ft8=9 * (8 + 2 * n_eval), qconv_dx8=9 * 8,
                 qgemm8=3 * (8 + 2 * n_eval), qgemm8_dx=3 * 8, qconv_dw_prep=9 * 8)
    if counts != want:
        raise RuntimeError(f"the corpus run's launches {counts}, expected {want} (9/9/3/3 a "
                           f"step and 9 of K, 9/3 an eval forward, {n_eval} eval batches "
                           f"twice)")
    # resume: the same batches and data states, losses within 1e-3 relative
    if batches_s != batches_w or len(batches_w) != 8:
        raise RuntimeError("the resumed run trained on other batches than the uninterrupted one")
    mgr_w = CheckpointManager(cfg, directory=whole, write_config=False)
    mgr_s = CheckpointManager(cfg, directory=split, write_config=False)
    states = [(mgr_w.restore_data_state(n), mgr_s.restore_data_state(n)) for n in (4, 8)]
    if any(a is None or a != b for a, b in states) or "resumed from step 4" not in out_s:
        raise RuntimeError(f"the resumed run's data states {states}")
    lw, ls = losses(whole), losses(split)
    rel = max(abs(lw[n]["loss"] - ls[n]["loss"]) / abs(lw[n]["loss"]) for n in range(5, 9))
    same_bits = all(lw[n]["loss"] == ls[n]["loss"] for n in range(1, 9))
    if not rel <= 1e-3 or not all(math.isfinite(lw[n]["loss"]) for n in range(1, 9)):
        raise RuntimeError(f"resumed losses off by {rel:.3e} relative (limit 1e-3)")
    # best.json: the step with the lower dev_per (the earlier on a tie)
    with open(os.path.join(whole, "metrics.jsonl")) as f:
        dev_rows = {r["step"]: r for r in map(json.loads, f) if "dev_per" in r}
    best_want = 8 if dev_rows[8]["dev_per"] < dev_rows[4]["dev_per"] else 4
    if mgr_w.best_step() != best_want or mgr_s.best_step() != best_want:
        raise RuntimeError(f"best.json points at {mgr_w.best_step()} / {mgr_s.best_step()}, "
                           f"expected {best_want} (dev_per {dev_rows[4]['dev_per']}, "
                           f"{dev_rows[8]['dev_per']})")
    # --eval-only reports what the loop logged at that step
    with contextlib.redirect_stdout(io.StringIO()):
        ev = cli.main(["--preset", "timit_qcnn", "--eval-only", "--split", "dev", "--set",
                       f"data.data_dir={timit}",
                       f"train.checkpoint_dir={whole}"])
    logged = dev_rows[best_want]
    if (ev["step"] != best_want or ev["per"] != logged["dev_per"]
            or not abs(ev["loss"] - logged["dev_loss"]) <= 1e-3 * abs(logged["dev_loss"])):
        raise RuntimeError(f"--eval-only gave {ev}, the loop logged {logged}")
    # transcribe the best step, as a user runs it
    dev_wavs = [u.wav_path for u in TimitDataset(timit, "dev").utterances[:2]]
    env = {**os.environ, "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run([sys.executable, "-m", "qasr_torch.cli", "transcribe", "--ckpt", whole,
                           "--fold", *dev_wavs], cwd=repo, env=env, capture_output=True,
                          text=True, timeout=300)
    served_lines = proc.stdout.rstrip("\n").split("\n")
    if proc.returncode != 0 or [ln.partition("\t")[0] for ln in served_lines] != dev_wavs:
        raise RuntimeError(f"transcribe exited {proc.returncode}:\n{proc.stdout}{proc.stderr}")
    rate = [lw[n]["audio_s_per_s_per_chip"] for n in range(2, 9)]
    print(f"phase 11 corpus (TIMIT): mini-TIMIT {written} utterances; timit_qcnn QCNN-256 bf16 "
          f"through the CLI, 8 steps in {whole_s:.2f} s (cache build included), launches "
          f"{counts} ({n_eval} eval batches of the {n_dev} dev utterances, twice); cache "
          f"{caches} built once, read after; interrupted after step 4 + --resume to 8: batches "
          f"and data states "
          f"equal, losses 5-8 max rel {rel:.3e} (tol 1e-3; all 8 the same bits: {same_bits}); "
          f"dev_per at 4 {dev_rows[4]['dev_per']:.4f}, at 8 {dev_rows[8]['dev_per']:.4f}, "
          f"best.json step {best_want}; --eval-only @ step {ev['step']} per {ev['per']:.4f} "
          f"loss {ev['loss']:.4f} (logged {logged['dev_loss']:.4f}); transcribe exit 0: "
          + " | ".join(repr(ln.partition("\t")[2][:60]) for ln in served_lines),
          flush=True)

    # config 4 on mini-LibriSpeech, streaming, with dev-clean evals
    libri = os.path.join(root, "libri")
    lwritten = make_mini_librispeech.write_corpus(libri, speakers=8, utts_per_speaker=12,
                                                  dev_speakers=4, seed=SEED)
    qcfg = get_config("librispeech_qlstm").override(**{
        "data.data_dir": libri, "data.cache_features": False, "train.warmup_steps": 2,
        "train.learning_rate": 1e-4, "train.num_steps": 4, "train.log_every": 1,
        "train.eval_every": 4, "train.checkpoint_every": 4,
        "train.checkpoint_dir": os.path.join(root, "qlstm")})
    q_dev = LibriFeaturePipeline(qcfg, "dev-clean", device=dev)
    n_qeval = len(list(epoch_iterator(q_dev, qcfg.data, train=False)))
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        qstate, qlast = loop.train(qcfg, device=dev)
    q_s = time.perf_counter() - t0
    qcounts = _read_counts()
    qwant = _want(qconv_ft8=3 * (4 + n_qeval), qconv_dx8=3 * 4, qlstm_scan8=3 * (4 + n_qeval),
                  qlstm_scan8_bwd=3 * 4, qgemm8=4 + n_qeval, qgemm8_dx=4, qconv_dw_prep=3 * 4)
    if qcounts != qwant or qstate.step != 4 or not math.isfinite(qlast["loss"]):
        raise RuntimeError(f"config 4's corpus run: launches {qcounts}, expected {qwant}; "
                           f"last {qlast}")
    served = Transcriber(qlast["checkpoint"], device=dev)
    qwavs = [q_dev.corpus.load(i)[0] for i in range(2)]
    texts = served.transcribe_batch(qwavs)
    if len(texts) != 2 or not all(isinstance(t, str) for t in texts):
        raise RuntimeError(f"config 4's checkpoint did not serve: {texts}")
    # streaming features against a cached build of the same split
    q_cached = LibriFeaturePipeline(qcfg, "dev-clean", cache_features=True, device=dev,
                                    cache_dir=os.path.join(root, "libri_cache"))
    q_dev.prefetch(range(len(q_dev)))
    feat_err = max(float(np.max(np.abs(q_dev[i].features - q_cached[i].features)))
                   for i in range(len(q_cached)))
    if not feat_err <= 1e-4:
        raise RuntimeError(f"streaming features differ from the cached build by {feat_err:.3e}")
    print(f"phase 11 corpus (LibriSpeech): mini-LibriSpeech {lwritten} utterances; "
          f"librispeech_qlstm bf16 streaming, 4 steps and a dev-clean eval ({n_qeval} batches) "
          f"in {q_s:.2f} s, last log {json.dumps({k: qlast[k] for k in sorted(qlast)})}; "
          f"launches {qcounts}; checkpoint served {[t[:30] for t in texts]}; streaming vs "
          f"cached features max_abs {feat_err:.3e} (tol 1e-4)", flush=True)
    del qstate, served
    torch.cuda.empty_cache()

    # timings, not gated: featurization on the card, cached build and
    # streaming blocks of 32, over mini-TIMIT's train split
    train_set = TimitDataset(timit, "train")
    n_train = len(train_set)
    audio_s = sum(len(train_set.load(i)[0]) for i in range(n_train)) / cfg.data.sample_rate
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    TimitFeaturePipeline(cfg, "train", device=dev, cache_dir=os.path.join(root, "fresh_cache"))
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    TimitFeaturePipeline(cfg, "train", device=dev, cache_dir=os.path.join(root, "fresh_cache"))
    read_s = time.perf_counter() - t0
    streaming = TimitFeaturePipeline(cfg, "train", device=dev, cache_features=False)
    t0 = time.perf_counter()
    streaming.prefetch(range(n_train))
    stream_s = time.perf_counter() - t0
    # the dev eval of the best step
    model = build_model(cfg, device=dev)
    model.load_state_dict(mgr_w.restore_params(best_want))
    loop.evaluate(cfg, model, dev_pipe)
    t0 = time.perf_counter()
    loop.evaluate(cfg, model, dev_pipe)
    eval_s = time.perf_counter() - t0
    del model
    # the idle share of one train step fed by the prefetch thread (cached and
    # streaming mini-TIMIT) against phase 5's synthetic step on one batch
    profiles = []
    tcfg = cfg.override(**{"train.warmup_steps": 2, "train.learning_rate": 1e-4})
    for what, pipe in (("cached", TimitFeaturePipeline(cfg, "train", device=dev)),
                       ("streaming", TimitFeaturePipeline(cfg, "train", device=dev,
                                                          cache_features=False))):
        st = create_train_state(tcfg, device=dev)
        pf = Prefetcher(BatchStream(pipe, tcfg.data, seed=SEED), depth=2)
        try:
            for _ in range(3):
                train_step(st, next(pf)[0])
            profiles.append(_profile(lambda: train_step(st, next(pf)[0]),
                                     f"one mini-TIMIT train step, {what}, fed by the prefetch "
                                     "thread", 11, smi, 3))
        finally:
            pf.close()
        del st
    st = create_train_state(tcfg8, device=dev)
    for _ in range(3):
        train_step(st, batch)
    profiles.append(_profile(lambda: train_step(st, batch), "one synthetic train step "
                             "B16xT256 (phase 5's batch)", 11, smi, 3))
    del st
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    print(f"phase 11 timing on {smi}: featurization of mini-TIMIT train ({n_train} utterances, "
          f"{audio_s:.1f} audio-s) cached build {build_s:.3f} s ({audio_s / build_s:.1f} "
          f"audio-s/s, .npz written), cache read {read_s:.3f} s, streaming blocks of 32 "
          f"{stream_s:.3f} s ({audio_s / stream_s:.1f} audio-s/s); train loop "
          f"audio_s_per_s_per_chip steps 2-8 {[round(v, 1) for v in rate]}; dev eval of "
          f"{n_dev} utterances {eval_s:.3f} s; phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    for line in profiles:
        print(line, flush=True)


def phase12_protocol(dev: torch.device, smi: str) -> None:
    """The paper's decode protocol on the card: ``timit_qcnn_fm32``'s kernel
    shapes held against the plain versions, then
    ``qasr_torch.tools.run_timit_protocol`` trained on mini-TIMIT, decoded by
    the W = 100 beam on dev and core test, and repeated with
    ``--skip-train``; the device beam against the host beam on one dev batch
    of the trained model. Gated: the kernels' parity, the line's keys, the
    best-dev-PER step, the PERs, the launches, the repeat's PERs and the two
    beams' agreement. Then, not gated: the training's seconds and
    audio-s/s, each beam eval's seconds and the two beams' seconds."""
    import contextlib
    import io

    from qasr_torch.configs import get_config
    from qasr_torch.data.batching import BatchStream, Prefetcher, epoch_iterator
    from qasr_torch.data.pipeline import TimitFeaturePipeline
    from qasr_torch.decode import ctc_beam_search_decode, ctc_beam_search_decode_host
    from qasr_torch.models import build_model
    from qasr_torch.ops.kernels.qconv_dx import qconv_dx8, qconv_dx_plain
    from qasr_torch.ops.kernels.qconv_ft import qconv_ft8, qconv_stacked_plain
    from qasr_torch.ops.kernels.qgemm8 import (
        conj_transpose_dense,
        qgemm8_cl,
        qgemm8_cl_plain,
        qgemm8_dx,
    )
    from qasr_torch.tools import run_timit_protocol
    from qasr_torch.train import loop
    from qasr_torch.train.checkpoint import CheckpointManager
    from qasr_torch.train.state import create_train_state
    from qasr_torch.train.step import batch_to_device, train_step

    t_phase = time.perf_counter()
    cfg = get_config("timit_qcnn_fm32")
    c = cfg.model.conv_features[1]
    k_in = 13 * c  # the first dense layer's K: 13 pooled bands of c channels
    g = torch.Generator(device=dev).manual_seed(SEED + 12)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    # kernels A, C and B at the fm32 path's shapes (the corpus's buckets of
    # 128 and 256 frames at B16), gated as in phase 3
    worst = {}
    for t in (128, 256):
        w = rnd(4, 3, 3, c, c, scale=(1.0 / (9 * c)) ** 0.5)
        bias, alpha = rnd(4 * c, scale=0.1), rnd(4 * c, scale=0.25).abs()
        slopes = rnd(4 * c, scale=0.25)
        x32, dz32 = rnd(16, 4, 13, t, c, scale=0.5), rnd(16, 4, 13, t, c)
        for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
            x, dz, dname = x32.to(dtype), dz32.to(dtype), str(dtype)[6:]
            shape = f"B16 F13 T{t} C{c} {dname}"
            checks = []  # (kernel, what, error); bf16 also against the bf16 plain version
            for bb, aa in ((None, None), (bias, alpha)):
                got = qconv_ft8(x, w, bb, aa)
                what = f"{shape} prologue+bias={bb is not None}"
                checks.append(("qconv_ft8", what, _errors(got, qconv_stacked_plain(
                    x.float(), w, bb, aa))))
                if dtype == torch.bfloat16:
                    checks.append(("qconv_ft8", what + " vs bf16 plain",
                                   _errors(got, qconv_stacked_plain(x, w, bb, aa))))
            for epi in (False, True):
                zz, sl = (x, slopes) if epi else (None, None)
                got, got_da = qconv_dx8(dz, w, zz, sl)
                ref, ref_da = qconv_dx_plain(dz.float(), w, None if zz is None else zz.float(), sl)
                what = f"{shape} epilogue={epi}"
                checks.append(("qconv_dx8", what + " dx", _errors(got, ref)))
                if epi:
                    checks.append(("qconv_dx8", what + " dalpha", _errors(got_da, ref_da)))
                if dtype == torch.bfloat16:
                    checks.append(("qconv_dx8", what + " dx vs bf16 plain",
                                   _errors(got, qconv_dx_plain(dz, w, zz, sl)[0])))
            for name, what, err in checks:
                _report(f"fm32 {name} {what}", err, tol, phase=12)
                worst[name] = max(worst.get(name, 0.0), err["rel_norm"])
        for k, n in ((k_in, 256), (256, 256)):
            m = 16 * t
            wd = rnd(4, k, n, scale=(1.0 / k) ** 0.5)
            xd32, dy32 = rnd(4, m, k, scale=0.5), rnd(4, m, n)
            for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
                x4, dy4, dname = xd32.to(dtype), dy32.to(dtype), str(dtype)[6:]
                err = _errors(qgemm8_cl(x4, wd), qgemm8_cl_plain(x4.float(), wd))
                _report(f"fm32 qgemm8 M{m} K{k} N{n} {dname}", err, tol, phase=12)
                worst["qgemm8"] = max(worst.get("qgemm8", 0.0), err["rel_norm"])
                err = _errors(qgemm8_dx(dy4, wd),
                              qgemm8_cl_plain(dy4.float(), conj_transpose_dense(wd)))
                _report(f"fm32 qgemm8_dx M{m} N{n} -> K{k} {dname}", err, tol, phase=12)
                worst["qgemm8_dx"] = max(worst.get("qgemm8_dx", 0.0), err["rel_norm"])
    del x32, dz32, x, dz, xd32, dy32, x4, dy4
    torch.cuda.empty_cache()
    print(f"phase 12 parity: kernels A, C and B at timit_qcnn_fm32's shapes (C{c}, K{k_in}, "
          f"B16 x T128 and T256) against their plain versions, f32 and bf16: worst rel_norm "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in worst.items()})}", flush=True)

    # the protocol, in this process (launches counted), as a user runs it
    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(repo, "qasr_torch", "_build", "smoke_protocol")
    shutil.rmtree(root, ignore_errors=True)
    data, ckpt = os.path.join(root, "timit"), os.path.join(root, "ckpt")
    argv = ["--make-mini", "--data-dir", data, "--ckpt", ckpt, "--preset", "timit_qcnn_fm32",
            "--device", str(dev), "--set", *PROTOCOL_SETS]
    seen = {"train_s": None, "evals": []}
    real_train, real_eval = loop.train, loop.evaluate

    def timed_train(*a, **kw):
        t0 = time.perf_counter()
        out = real_train(*a, **kw)
        torch.cuda.synchronize()
        seen["train_s"] = time.perf_counter() - t0
        return out

    def timed_eval(cfg_, model, dataset, *, beam=False, **kw):
        t0 = time.perf_counter()
        out = real_eval(cfg_, model, dataset, beam=beam, **kw)
        seen["evals"].append((beam, dataset.corpus.split, time.perf_counter() - t0))
        return out

    loop.train, loop.evaluate = timed_train, timed_eval
    out = io.StringIO()
    _reset_counts()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            returned = run_timit_protocol.main(argv)
        protocol_s = time.perf_counter() - t0
    finally:
        loop.train, loop.evaluate = real_train, real_eval
    counts = _read_counts()
    lines = out.getvalue().splitlines()
    if len(lines) != 1 or json.loads(lines[0]) != returned or list(returned) != PROTOCOL_KEYS:
        raise RuntimeError(f"the protocol printed {lines!r}, expected one JSON line with the "
                           f"keys {PROTOCOL_KEYS}")
    line = returned
    pcfg = cfg.override(**dict(kv.split("=", 1) for kv in PROTOCOL_SETS),
                        **{"data.data_dir": data, "train.checkpoint_dir": ckpt})
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        rows = [json.loads(r) for r in f]
    dev_rows = {r["step"]: r["dev_per"] for r in rows if "dev_per" in r}
    best = min(dev_rows, key=lambda st: (dev_rows[st], st))  # best.json keeps the earlier tie
    if (line["selected_by"] != "best_dev_per" or line["step"] != best or not line["trained_here"]
            or (line["beam_width"], line["beam_prune_logp"]) != (100, -20.0)):
        raise RuntimeError(f"the protocol selected {line}; the lowest logged dev_per is step "
                           f"{best} ({dev_rows})")
    if not (line["dev_per"] <= PROTOCOL_PER_MAX and line["test_per"] <= PROTOCOL_PER_MAX):
        raise RuntimeError(f"protocol PER dev {line['dev_per']} core-test {line['test_per']} "
                           f"above {PROTOCOL_PER_MAX} (the JAX package: 0.0839, 0.0726)")
    # launches: 9/9/3/3 a train step, 9/3 an eval forward (the greedy dev
    # evals every eval_every steps and the two beam evals)
    n_batches = {split: len(list(epoch_iterator(TimitFeaturePipeline(pcfg, split, device=dev),
                                                pcfg.data, train=False)))
                 for split in ("dev", "core_test")}
    n_steps = pcfg.train.num_steps
    n_fwd = n_steps + (n_steps // pcfg.train.eval_every + 1) * n_batches["dev"] \
        + n_batches["core_test"]
    want = _want(qconv_ft8=9 * n_fwd, qconv_dx8=9 * n_steps, qgemm8=3 * n_fwd,
                 qgemm8_dx=3 * n_steps, qconv_dw_prep=9 * n_steps)
    evals = [(b, sp) for b, sp, _ in seen["evals"]]
    want_evals = [(False, "dev")] * (n_steps // pcfg.train.eval_every) + [(True, "dev"),
                                                                        (True, "core_test")]
    if counts != want or evals != want_evals:
        raise RuntimeError(f"the protocol's launches {counts}, expected {want}; evals {evals}, "
                           f"expected {want_evals}")

    # --skip-train, as a user runs it: the same PERs exactly
    env = {**os.environ, "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run([sys.executable, "-m", "qasr_torch.tools.run_timit_protocol", *argv,
                           "--skip-train"], cwd=repo, env=env, capture_output=True, text=True,
                          timeout=600)
    again = json.loads(proc.stdout) if proc.returncode == 0 else None
    if (again is None or again["trained_here"] or again["step"] != line["step"]
            or (again["dev_per"], again["test_per"]) != (line["dev_per"], line["test_per"])):
        raise RuntimeError(f"--skip-train exited {proc.returncode} with {proc.stdout!r} "
                           f"{proc.stderr[-2000:]}, expected the PERs of {line}")

    # the device beam against the host beam on one dev batch of the trained
    # model (the protocol's width, pruning and max_len)
    model = build_model(pcfg, device=dev)
    model.load_state_dict(CheckpointManager(pcfg, write_config=False).restore_params(line["step"]))
    model.eval()
    dev_pipe = TimitFeaturePipeline(pcfg, "dev", device=dev)
    batch = batch_to_device(next(iter(epoch_iterator(dev_pipe, pcfg.data, train=False))), dev)
    with torch.no_grad():
        logits = model(batch["features"], lengths=batch["feature_lengths"])
    lengths = batch["feature_lengths"]
    kw = dict(beam_width=pcfg.decode.beam_width, blank_id=pcfg.decode.blank_id,
              max_len=pcfg.data.max_label_len, prune_logp=pcfg.decode.beam_prune_logp)
    beam_s = []
    for _ in range(2):  # the second call's seconds are reported
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d_seq, d_lens, d_score = ctc_beam_search_decode(logits, lengths, **kw)
        torch.cuda.synchronize()
        beam_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    h_seq, h_lens, h_score = ctc_beam_search_decode_host(logits, lengths, **kw)
    host_s = time.perf_counter() - t0
    d_seq, d_lens, d_score = d_seq.cpu().numpy(), d_lens.cpu().numpy(), d_score.cpu().numpy()
    score_err = float(np.max(np.abs(d_score - h_score)))
    if (not np.array_equal(d_lens, h_lens) or not np.array_equal(d_seq, h_seq)
            or not score_err <= 1e-3):
        raise RuntimeError(f"device beam vs host beam: lengths {d_lens} / {h_lens}, sequences "
                           f"equal {np.array_equal(d_seq, h_seq)}, scores max diff {score_err:.3e}")
    del model, logits
    # where a step of the protocol's training goes: one step fed by the
    # prefetch thread under the profiler (not gated)
    st = create_train_state(pcfg, device=dev)
    pf = Prefetcher(BatchStream(TimitFeaturePipeline(pcfg, "train", device=dev), pcfg.data,
                                seed=SEED), depth=2)
    try:
        for _ in range(3):
            train_step(st, next(pf)[0])
        profile = _profile(lambda: train_step(st, next(pf)[0]), "one timit_qcnn_fm32 train step "
                           "on mini-TIMIT, fed by the prefetch thread", 12, smi, 4)
    finally:
        pf.close()
    del st
    torch.cuda.empty_cache()
    rate = [r["audio_s_per_s_per_chip"] for r in rows if "audio_s_per_s_per_chip" in r]
    eval_s = {f"{'beam' if b else 'greedy'} {sp}": round(s_, 3) for b, sp, s_ in seen["evals"]
              if b}
    greedy_s = [round(s_, 3) for b, _, s_ in seen["evals"] if not b]
    shutil.rmtree(root, ignore_errors=True)
    print(f"phase 12 protocol: {json.dumps(line)}; dev PER {line['dev_per']} and core-test PER "
          f"{line['test_per']} (the JAX package on the TPU v5e: 0.0839, 0.0726; limit "
          f"{PROTOCOL_PER_MAX}); best.json step {best} of the logged {dev_rows}; launches "
          f"{counts} ({n_steps} steps, {n_batches} batches of dev and core test); --skip-train "
          f"(a subprocess) printed the same PERs", flush=True)
    print(f"phase 12 beam on {smi}: one dev batch B{len(d_lens)} x T{batch['features'].shape[1]} "
          f"(W {kw['beam_width']}, prune {kw['prune_logp']}, max_len {kw['max_len']}): device "
          f"beam = host beam (sequences and lengths equal, scores max diff {score_err:.3e}, tol "
          f"1e-3); device {beam_s[1]:.3f} s (first call {beam_s[0]:.3f}), host {host_s:.3f} s",
          flush=True)
    print(f"phase 12 timing on {smi}: protocol {protocol_s:.1f} s, train() {n_steps} steps "
          f"{seen['train_s']:.1f} s ({seen['train_s'] / n_steps * 1e3:.2f} ms a step with its "
          f"evals and checkpoints), the loop's audio_s_per_s_per_chip median "
          f"{float(np.median(rate)):.1f} (min {min(rate):.1f}, max {max(rate):.1f}, "
          f"{len(rate)} windows); greedy dev evals {greedy_s} s; beam evals {eval_s} s; "
          f"phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    print(profile, flush=True)


def _old_qgemm8_plain(x4: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Kernel B's plain version as it was before its products were kept in
    f32: each of the eight products rounded to x's dtype before the f32 O8
    fold. Kept here only to record how far the kernel was from it."""
    from qasr_torch.ops.kernels.qgemm8 import combos8
    from qasr_torch.ops.quaternion import O8, combine_weights, device_table

    prods = torch.bmm(combos8(x4), combine_weights(w, x4.dtype)).float()
    return torch.einsum("pmn,bp->bmn", prods, device_table(O8, torch.float32, x4.device)).to(
        x4.dtype)


def _old_qgemm8_dw(x4: torch.Tensor, dy4: torch.Tensor) -> torch.Tensor:
    """``qgemm8_dw`` as it was: its products rounded to the compute dtype
    before the f32 fold (both branches). For the before-and-after timing."""
    from qasr_torch.ops.quaternion import HAMILTON_E, O8_T, U8, V8, device_table

    k, n = x4.shape[2], dy4.shape[2]
    if k * n >= 1 << 20:
        xc = torch.einsum("amk,pa->pmk", x4, device_table(V8, x4.dtype, x4.device))
        dyc = torch.einsum("bmn,pb->pmn", dy4, device_table(O8_T, dy4.dtype, dy4.device))
        dwc8 = torch.bmm(xc.transpose(1, 2), dyc).float()
        return torch.einsum("pkn,pa->akn", dwc8, device_table(U8, torch.float32, x4.device))
    dw_big = torch.einsum("amk,bmn->akbn", x4, dy4).float()
    return torch.einsum("akbn,cab->ckn", dw_big,
                        device_table(HAMILTON_E, torch.float32, x4.device))


# Phase 13's arms of config 4: the overrides of each, and the input
# projection it routes to (None: the real ablation, which runs no kernel of
# the port). None of them launches D or E.
QLSTM_ARMS = {
    "block": ({"model.op_variant": "block"}, "block"),
    "fast8": ({"model.op_variant": "fast8"}, "fast8"),
    "unidirectional": ({"model.bidirectional": False}, "auto"),
    "real_lstm": ({"model.arch": "real_lstm"}, None),
}


def _arm_launches(proj: str | None, layers: int, rows: int, step: bool) -> dict:
    """An arm's launches of the port's kernels a forward (or a train step)
    at ``rows`` = B*T: A for the tower's three stacked layers, B for the
    dense layer and for each input projection that takes kernel B
    (``input_proj_fn``: fast8 always, auto below ``BLOCK_ROWS``); in a step
    also C, and B's dx role as often as B."""
    from qasr_torch.models.qlstm import input_proj_fn
    from qasr_torch.ops.kernels.qgemm8 import qdense_pallas8

    if proj is None:
        return {}
    n_b = 1 + (layers if input_proj_fn(proj, rows) is qdense_pallas8 else 0)
    return dict(qconv_ft8=3, qgemm8=n_b,
                **(dict(qconv_dx8=3, qgemm8_dx=n_b, qconv_dw_prep=3) if step else {}))


# the f32 plain paths of the block, fast8 and default arms on the same
# weights compute one function: only their sums' order differs (the input
# projection as the block product or the rank-8 GEMM, the recurrence as the
# block product, the fast8 loop or kernel D's plain version), ~1e-6 a layer
TOL_ARMS_F32 = {"rel_norm": 1e-4}


def phase13_qlstm_arms(dev: torch.device, smi: str) -> None:
    """Config 4's other arms at full width: ``op_variant`` block and fast8,
    the unidirectional encoder and the real ablation ``real_lstm``, served,
    trained and timed; and the rank-8 GEMM's f32 products on the card."""
    from qasr_torch.configs import get_config
    from qasr_torch.infer import Transcriber
    from qasr_torch.models import build_model
    from qasr_torch.models.qlstm import RealBiLSTM
    from qasr_torch.ops.kernels import qgemm8
    from qasr_torch.ops.kernels.qgemm8 import (
        conj_transpose_dense,
        f32_bmm,
        qgemm8_cl,
        qgemm8_cl_plain,
        qgemm8_dw,
        qgemm8_dx,
    )
    from qasr_torch.train.state import create_train_state
    from qasr_torch.train.step import train_step

    t_phase = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED + 13)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    bf16 = torch.bfloat16
    cfg = get_config("librispeech_qlstm")
    T, B, H = cfg.data.bucket_sizes[0], cfg.data.batch_size, cfg.model.lstm_features

    # (a) kernel B against its plain version in bf16 at phases 3, 7 and 8's
    # shapes, now that the plain version keeps its products in f32 (gated at
    # phase 3's limits), and the distance to the plain version as it was
    # (bf16 products; not gated); the dW's products on the card in f32
    # against the f32 operands' (summation order only, TOL_F32)
    nf, conv = 13, cfg.model.conv_features
    shapes = (*PHASE3_GEMMS, (4 * T, nf * conv[-1], 8 * H), (4 * T, 2 * H, 8 * H),
              (4 * T, 2 * H, 256), (B * T, 2 * H, 256))
    dist = []
    for m, k, n in shapes:
        w = rnd(4, k, n, scale=k ** -0.5)
        x4, dy4 = rnd(4, m, k, scale=0.5).to(bf16), rnd(4, m, n).to(bf16)
        for role, got, new, old in (
                ("fwd", qgemm8_cl(x4, w), qgemm8_cl_plain(x4, w), _old_qgemm8_plain(x4, w)),
                ("dx", qgemm8_dx(dy4, w), qgemm8_cl_plain(dy4, conj_transpose_dense(w)),
                 _old_qgemm8_plain(dy4, conj_transpose_dense(w)))):
            err_new, err_old = _errors(got, new), _errors(got, old)
            _gate(f"qgemm8 {role} M{m} K{k} N{n} bf16 vs the f32-product plain version",
                  err_new, TOL_BF16)
            dist.append((f"{role} M{m} K{k} N{n}", err_new["rel_norm"], err_old["rel_norm"],
                         (got != new).float().mean().item(), (got != old).float().mean().item()))
        # the same dW with f32_bmm's products on upcast operands instead
        dw = qgemm8_dw(x4, dy4)
        qgemm8.f32_bmm = lambda a, b: torch.bmm(a.float(), b.float())
        try:
            ref = qgemm8_dw(x4, dy4)
        finally:
            qgemm8.f32_bmm = f32_bmm
        _gate(f"qgemm8_dw M{m} K{k} N{n} bf16 on the card vs f32 operands", _errors(dw, ref),
              TOL_F32)
        del x4, dy4, w
    print("phase 13 rank-8 f32 products: kernel B in bf16 against its plain version, rel_norm "
          "now / before (bf16 products), share of outputs differing now / before (gated now at "
          f"{TOL_BF16}): " + "; ".join(f"{s} {a:.3e} / {b:.3e}, {c:.4f} / {d:.4f}"
                                      for s, a, b, c, d in dist)
          + "; qgemm8_dw on the card's bf16 GEMM with an f32 output = f32 operands (TOL_F32)",
          flush=True)
    dw_times = []
    for m, k, n in (PHASE3_GEMMS[0], PHASE3_GEMMS[2], (B * T, 2 * H, 256),
                    (4 * T, nf * conv[-1], 8 * H)):
        x4, dy4 = rnd(4, m, k, scale=0.5).to(bf16), rnd(4, m, n).to(bf16)
        new_ms, old_ms = _alternating(lambda: qgemm8_dw(x4, dy4), lambda: _old_qgemm8_dw(x4, dy4),
                                      5)
        dw_times.append((m, k, n, new_ms, old_ms))
        del x4, dy4
    torch.cuda.empty_cache()

    # the arms' weights: the default arm's (kernel D), which block and fast8
    # load under the same names; the unidirectional and real encoders draw
    # their own. Serving and gradient parity run at one LSTM layer (depth
    # cut: the plain loops are host-bound), launches and times at full depth
    tcfg, batch = _qlstm_train_batch(cfg)
    lens = torch.as_tensor(batch["feature_lengths"], device=dev)
    feats = torch.as_tensor(batch["features"], device=dev)
    audio_s = B * T * FRAME_S
    one = {"model.lstm_layers": 1}
    default = build_model(cfg.override(**one), generator=torch.Generator().manual_seed(SEED),
                          device=dev)
    if default.recurrent != "pallas8":
        raise RuntimeError(f"config 4's default arm routes to {default.recurrent}")
    params = default.state_dict()
    with torch.no_grad():
        ref_bf16 = default(feats, lengths=lens)
        cfg32 = cfg.override(**{**one, "model.compute_dtype": "float32"})
        d32 = build_model(cfg32, device=dev)
        d32.load_state_dict(params)
        ref_f32 = d32(feats, lengths=lens, plain=True)
    del default, d32
    rng = np.random.default_rng(SEED + 13)
    wavs = [(0.1 * rng.standard_normal(int(n_s * cfg.data.sample_rate))).astype(np.float32)
            for n_s in (2.3, 3.9)]
    repo = os.path.dirname(os.path.abspath(__file__))
    rows = {}
    for arm, (over, proj) in QLSTM_ARMS.items():
        acfg = cfg.override(**over)
        fwd_want = _arm_launches(proj, 1, B * T, False)
        step_want = _arm_launches(proj, acfg.model.lstm_layers, B * T, True)
        enc = build_model(acfg.override(**one), generator=torch.Generator().manual_seed(SEED + 1),
                          device=dev)
        same_weights = arm in ("block", "fast8")
        if same_weights:
            enc.load_state_dict(params)
        # serving: one forward of the kernel path with its launches, the
        # plain path, and the f32 plain path on the same weights
        with torch.no_grad():
            _reset_counts()
            logits = enc(feats, lengths=lens)
            counts = _read_counts()
            if counts != _want(**fwd_want):
                raise RuntimeError(f"{arm}: launches a forward {counts}, expected {fwd_want}")
            plain = enc(feats, lengths=lens, plain=True)
            e32 = build_model(acfg.override(**{**one, "model.compute_dtype": "float32"}),
                              device=dev)
            e32.load_state_dict(enc.state_dict())
            plain32 = e32(feats, lengths=lens, plain=True)
            del e32
        if tuple(logits.shape) != (B, T, cfg.model.vocab):
            raise RuntimeError(f"{arm}: logits {tuple(logits.shape)}")
        lerr = _errors(logits, plain)
        _gate(f"{arm} logits kernel vs plain", lerr, TOL_LOGITS)
        kerr32 = _errors(logits, plain32)
        _gate(f"{arm} logits kernel vs f32 plain", kerr32, TOL_LOGITS_F32)
        _gate(f"{arm} logits plain bf16 vs f32 plain", _errors(plain, plain32), TOL_LOGITS_F32)
        line = (f"phase 13 serving {arm}: one LSTM layer, B{B}xT{T} ragged, logits finite; "
                f"launches a forward "
                f"{ {k: v for k, v in counts.items() if v} }; kernel vs plain rel_norm "
                f"{lerr['rel_norm']:.3e}, vs f32 plain {kerr32['rel_norm']:.3e}")
        if same_weights:
            a32, a16 = _errors(plain32, ref_f32), _errors(logits, ref_bf16)
            _gate(f"{arm} vs the default arm, f32 plain", a32, TOL_ARMS_F32)
            _gate(f"{arm} vs the default arm, bf16", a16, TOL_LOGITS)
            line += (f"; against the default arm (kernel D) on the same weights: f32 plain "
                     f"rel_norm {a32['rel_norm']:.3e} (tol {TOL_ARMS_F32}), bf16 "
                     f"{a16['rel_norm']:.3e} (tol {TOL_LOGITS})")
        print(line, flush=True)
        del logits, plain, plain32
        torch.cuda.empty_cache()

        # training: gradient parity where a kernel is on the path (one LSTM
        # layer), the launches of one step at full depth; then (not gated) a
        # second step's and a forward's time, and a profiled block-arm step
        atcfg = tcfg.override(**over)
        if proj is not None:
            _grad_parity(atcfg.override(**one), batch, dev, 13, f"{arm}: one LSTM layer, ")
        enc = build_model(acfg, generator=torch.Generator().manual_seed(SEED + 1), device=dev)
        state = create_train_state(atcfg, device=dev)
        _reset_counts()
        train_step(state, batch)
        counts = _read_counts()
        if counts != _want(**step_want):
            raise RuntimeError(f"{arm}: launches a train step {counts}, expected {step_want}")
        step_ms = _time_ms(lambda: train_step(state, batch), 1, 0)
        with torch.no_grad():
            fwd_ms = _time_ms(lambda: enc(feats, lengths=lens), 1, 1)
        prof = (_profile(lambda: train_step(state, batch), f"one {arm}-arm train step B{B}xT{T}",
                         13, smi, 6) if arm == "block" else None)
        del state, enc
        torch.cuda.empty_cache()
        # the loops run ~20 small ops a step on the host: twenty steps on one
        # batch and a checkpoint that serves, at one LSTM layer and a quarter
        # of the frames (depth and length cut)
        dcfg, dbatch = _qlstm_train_batch(acfg.override(**{
            "model.lstm_layers": 1, "data.bucket_sizes": (T // 4,)}))
        state = create_train_state(dcfg, device=dev)
        losses = [train_step(state, dbatch)["loss"].item() for _ in range(20)]
        if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
            raise RuntimeError(f"{arm}: twenty steps on one batch did not lower the loss: {losses}")
        del state
        lcfg = dcfg.override(**{"train.num_steps": 2, "train.log_every": 1,
                                "train.eval_every": 2, "train.checkpoint_every": 2})
        if arm == "real_lstm":
            # through the command line, as a user trains it
            ckpt = os.path.join(repo, "qasr_torch", "_build", "smoke_real_lstm")
            shutil.rmtree(ckpt, ignore_errors=True)
            sets = ["model.arch=real_lstm", "model.lstm_layers=1", "data.dataset=synthetic",
                    f"data.bucket_sizes={T // 4}", f"data.max_label_len={T // 32}",
                    "train.warmup_steps=2", "train.learning_rate=1e-4", "train.num_steps=2",
                    "train.log_every=1", "train.eval_every=2", "train.checkpoint_every=2",
                    f"train.checkpoint_dir={ckpt}"]
            env = {**os.environ,
                   "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "qasr_torch.cli", "--preset",
                                   "librispeech_qlstm", "--set", *sets], cwd=repo, env=env,
                                  capture_output=True, text=True, timeout=600)
            train_s = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"real_lstm through the CLI failed:\n{proc.stderr[-3000:]}")
            last = json.loads(proc.stdout.strip().splitlines()[-1])
            served = Transcriber(last["checkpoint"], device=dev)
            hyp = served.transcribe_batch(wavs)
            if last["step"] != 2 or not math.isfinite(last["loss"]) or len(hyp) != len(wavs) \
                    or type(served.model).__name__ != "RealLSTMEncoder":
                raise RuntimeError(f"real_lstm: the CLI run gave {last}, served {hyp}")
            del served
            shutil.rmtree(ckpt, ignore_errors=True)
            how = "python -m qasr_torch.cli"
        else:
            last, _, hyp, train_s = _train_and_serve(
                lcfg, dev, f"smoke_qlstm_{arm}",
                wavs, {k: v for k, v in _arm_launches(proj, 1, B * T // 4, True).items()
                       if "dx" in k or k == "qconv_dw_prep"})
            how = "train()"
        print(f"phase 13 train {arm}: launches a step {({k: v for k, v in counts.items() if v})};"
              f" one LSTM layer, B{B}xT{T // 4}: loss over 20 steps on one batch {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}, {how} 2 steps in {train_s:.2f} s (loss {last['loss']:.4f}), "
              f"its checkpoint served {len(hyp)} utterances", flush=True)
        if prof:
            print(prof, flush=True)
        rows[arm] = (fwd_ms, step_ms)
        torch.cuda.empty_cache()

    # the default arm's step on the same batch (kernels D and E), the
    # real ablation's counterpart of vs_baseline
    state = create_train_state(tcfg, device=dev)
    def_ms = _time_ms(lambda: train_step(state, batch), 3, 1)
    del state
    # the real recurrence's yardstick: one RealBiLSTM layer at layer 1's
    # shape (2 x 4H real features in, 4H units a direction) forward and
    # forward + backward, against one cuDNN nn.LSTM of the same size
    hr = 4 * H
    layer = RealBiLSTM(2 * hr, hr, dtype=bf16, device=dev,
                       generator=torch.Generator().manual_seed(SEED + 5))
    xl = rnd(B, T, 2 * hr, scale=0.5).to(bf16).requires_grad_()
    dy = rnd(B, T, 2 * hr).to(bf16)
    lstm = torch.nn.LSTM(2 * hr, hr, batch_first=True, bidirectional=True, device=dev).to(bf16)
    lstm.flatten_parameters()

    def fb(fn):
        def run():
            xl.grad = None
            fn(xl).backward(dy)
        return run

    with torch.no_grad():
        real_f = _time_ms(lambda: layer(xl), 2, 1)
        lib_f = _time_ms(lambda: lstm(xl)[0], 3, 1)
    real_fb = _time_ms(fb(layer), 2, 1)
    lib_fb = _time_ms(fb(lambda v: lstm(v)[0]), 3, 1)
    del layer, lstm, xl, dy
    torch.cuda.empty_cache()
    print(f"phase 13 timing on {smi}: B{B}xT{T} ragged bf16, forward / train step ms (audio-s/s): "
          + "; ".join(f"{a} {f:.3f} ({audio_s / f * 1e3:.1f}) / {s:.3f} "
                      f"({audio_s / s * 1e3:.1f})" for a, (f, s) in rows.items())
          + f"; default arm (kernels D, E) step {def_ms:.3f} ms ({audio_s / def_ms * 1e3:.1f}); "
          f"real_lstm step / default step {rows['real_lstm'][1] / def_ms:.3f}; one RealBiLSTM "
          f"layer ({2 * hr} in, {hr} units) forward {real_f:.3f} ms, forward + backward "
          f"{real_fb:.3f} ms, cuDNN nn.LSTM bf16 {lib_f:.3f} ms, {lib_fb:.3f} ms; qgemm8_dw "
          "f32 products / bf16 products ms: " + "; ".join(
              f"M{m} K{k} N{n} {a:.3f} / {b:.3f}" for m, k, n, a, b in dw_times)
          + f"; phase {time.perf_counter() - t_phase:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# Phase 14: data, tensor and sequence parallelism (qasr_torch/parallel/).
# The configurations and inputs below are built alike by this process (the
# one-process references) and by the two ranks (``--phase14-rank``).

P14_T = 256  # frames of every phase-14 utterance
P14_TIMEOUT_S = 420  # the two ranks' wall-clock limit
P14_SCRIPT = os.path.abspath(__file__)  # what the ranks run (``--phase14-rank``)
P14_CLI_PRESET = "timit_qcnn"
P14_CLI_SETS = {"data.dataset": "synthetic", "data.n_mels": "40", "model.vocab": "62",
                "data.bucket_sizes": "256", "train.warmup_steps": "2",
                "train.learning_rate": "1e-4", "train.num_steps": "4", "train.log_every": "2",
                "train.eval_every": "4", "train.checkpoint_every": "4"}


def _p14_timit(dtype: str):
    """timit_qcnn at full width in ``dtype`` with phase 6's training
    overrides; the preset's dropout (0.3) stays on: a data-parallel rank
    draws the global batch's masks."""
    from qasr_torch.configs import get_config

    return get_config("timit_qcnn").override(**TRAIN_OVERRIDES,
                                             **{"model.compute_dtype": dtype})


def _p14_large():
    """Config 5 (``librispeech_large``: conv 64..256 x 10, dense 1024 x 3,
    bf16) at full width on synthetic data: 8 utterances of 256 frames with
    32 characters, warmup 0 (its one step moves the weights), rate 1e-4."""
    from qasr_torch.configs import get_config

    return get_config("librispeech_large").override(**{
        "data.dataset": "synthetic", "data.bucket_sizes": (P14_T,), "data.batch_size": 8,
        "data.max_label_len": 32, "train.warmup_steps": 0, "train.learning_rate": 1e-4})


def _p14_large_batch(cfg) -> dict:
    rng = np.random.default_rng(SEED + 14)
    b = cfg.data.batch_size
    return {"features": rng.standard_normal((b, P14_T, cfg.data.n_mels, 4)).astype(np.float32),
            "feature_lengths": np.full(b, P14_T, np.int32),
            "labels": rng.integers(1, cfg.model.vocab, size=(b, 32)).astype(np.int32),
            "label_lengths": np.full(b, 32, np.int32), "real_rows": np.ones(b, bool)}


def _p14_conv_inputs(dev):
    """The halo conv's input x [B4, T256, F13, 4 x 256] (bf16), its f32
    kernel [4, 3, 3, 256, 256] and the output's cotangent (bf16)."""
    rng = np.random.default_rng(SEED + 15)
    x = rng.standard_normal((4, P14_T, 13, 1024)) * 0.5
    w = rng.standard_normal((4, 3, 3, 256, 256)) * (1.0 / (9 * 256)) ** 0.5
    g = rng.standard_normal((4, P14_T, 13, 1024))
    return (torch.from_numpy(x.astype(np.float32)).to(dev, torch.bfloat16),
            torch.from_numpy(w.astype(np.float32)).to(dev),
            torch.from_numpy(g.astype(np.float32)).to(dev, torch.bfloat16))


def _p14_ctc_inputs(dev):
    """B16 x T256 x V62 logits (f32) with 20-40 labels a row and ragged
    lengths (192-256 frames)."""
    rng = np.random.default_rng(SEED + 16)
    b, v, lab = 16, 62, 40
    ll = rng.integers(P14_T * 3 // 4, P14_T + 1, size=b)
    ll[0] = P14_T
    return (torch.from_numpy((2 * rng.standard_normal((b, P14_T, v))).astype(np.float32)).to(dev),
            torch.from_numpy(rng.integers(1, v, size=(b, lab))).to(dev),
            torch.from_numpy(ll).to(dev),
            torch.from_numpy(rng.integers(lab // 2, lab + 1, size=b)).to(dev))


def _p14_eval_set(cfg):
    """13 synthetic utterances in batches of 8 (the last has 5 real rows)."""
    from qasr_torch.data.synthetic import SyntheticDataset

    ecfg = cfg.override(**{"data.num_synthetic": 13, "data.batch_size": 8})
    return ecfg, SyntheticDataset(vocab=ecfg.model.vocab, n_mels=ecfg.data.n_mels,
                                  num_examples=13, seed=SEED)


def _p14_stack(x: torch.Tensor) -> torch.Tensor:
    from qasr_torch.models.layers import tf_packed_to_stacked

    return tf_packed_to_stacked(x).contiguous()


def phase14_rank(rank: int, directory: str, device: str = "cuda:0") -> int:
    """One of phase 14's two ranks, both on ``cuda:0`` over gloo
    (``--phase14-rank R --phase14-dir D``): the collectives gloo runs on
    CUDA tensors, ``timit_qcnn`` at DP 2 (bf16 and f32, two steps),
    ``librispeech_large`` at DP 1 x TP 2 (one step), the halo conv on kernel
    A, the chunked CTC and the sharded W = 100 beam eval. Writes
    ``rank<R>.json`` (and rank 0 ``rank0.pt``) into D."""
    import torch.distributed as dist

    from qasr_torch.ops.kernels import _build
    from qasr_torch.parallel import (
        create_sharded_train_state,
        ctc_loss_seq_parallel,
        initialize_multihost,
        make_mesh,
        make_sharded_train_step,
        qconv2d_seq_parallel,
    )
    from qasr_torch.parallel.collectives import all_gather_cat
    from qasr_torch.train.loop import evaluate
    from qasr_torch.train.metrics import state_bytes
    from qasr_torch.train.state import create_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    _build.load_library()
    initialize_multihost(f"file://{os.path.join(directory, 'rendezvous')}", num_processes=2,
                         process_id=rank, backend="gloo", device=dev)
    res, keep = {}, {}

    # which collectives gloo runs on CUDA tensors, with their values (each a
    # collective: both ranks take the same branch)
    probes = {}
    x = torch.full((4,), float(rank + 1), device=dev, dtype=torch.bfloat16)

    def probe(name, fn, want):
        try:
            got = fn()
            probes[name] = "ok" if torch.equal(got.float().cpu(), torch.tensor(want)) else \
                f"wrong values {got.tolist()}"
        except Exception as e:  # noqa: BLE001 - the finding is the refusal
            probes[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:90]}"

    def run(op, out, *args, **kw):
        op(out, *args, **kw)
        return out

    probe("all_reduce", lambda: run(dist.all_reduce, x.clone()), [3.0] * 4)
    probe("broadcast", lambda: run(dist.broadcast, x.clone(), src=0), [1.0] * 4)
    probe("all_gather", lambda: all_gather_cat(x, None, dim=0), [1.0] * 4 + [2.0] * 4)
    probe("all_gather_into_tensor", lambda: run(dist.all_gather_into_tensor,
                                                torch.empty(8, device=dev), x.float()),
          [1.0] * 4 + [2.0] * 4)
    probe("reduce_scatter_tensor", lambda: run(dist.reduce_scatter_tensor,
                                               torch.empty(2, device=dev), x.float()), [3.0] * 2)
    res["collectives"] = probes

    def timed(fn):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        return out, e0.elapsed_time(e1)

    # timit_qcnn at DP 2 on phase 6's batch: two steps (the first at rate 0)
    dp = make_mesh(2, 1)
    for dtype in ("bfloat16", "float32"):
        cfg = _p14_timit(dtype)
        batch = _train_batch(cfg)
        state, _ = create_sharded_train_state(cfg, dp, device=dev)
        step = make_sharded_train_step(cfg, dp)
        _reset_counts()
        m0 = step(state, batch)
        counts = _read_counts()
        m1, ms = timed(lambda: step(state, batch))
        res[f"dp2 {dtype}"] = {"loss": [m0["loss"].item(), m1["loss"].item()],
                               "grad_norm": [m0["grad_norm"].item(), m1["grad_norm"].item()],
                               "launches": counts, "step_ms": ms}
        keep[f"dp2 {dtype}"] = {k: v.cpu() for k, v in state.model.state_dict().items()}
        del state
        torch.cuda.empty_cache()

    # config 5 at DP 1 x TP 2: one step; the rank's bytes
    tp = make_mesh(1, 2)
    cfg5 = _p14_large()
    state, _ = create_sharded_train_state(cfg5, tp, device=dev)
    step = make_sharded_train_step(cfg5, tp)
    _reset_counts()
    m, ms = timed(lambda: step(state, _p14_large_batch(cfg5)))
    counts = _read_counts()
    persistent, gathered = state_bytes(state)
    res["tp2 large"] = {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
                        "launches": counts, "step_ms": ms,
                        "persistent": sum(persistent.values()),
                        "gathered": sum(gathered.values())}
    keep["tp2 large"] = {k: v.cpu() for k, v in state.model.state_dict().items()}
    del state
    torch.cuda.empty_cache()

    # the halo conv on kernel A (forward) and C (backward), T split in two
    sp = make_mesh(2, 1)
    x, w, g = _p14_conv_inputs(dev)
    rows = slice(rank * P14_T // 2, (rank + 1) * P14_T // 2)
    xl = x[:, rows].contiguous().requires_grad_(True)
    wl = w.clone().requires_grad_(True)
    _reset_counts()

    def conv():
        y = qconv2d_seq_parallel(xl, wl.to(torch.bfloat16), sp, variant="fast8")
        y.backward(g[:, rows])
        return y

    y, ms = timed(conv)
    counts = _read_counts()
    dw = wl.grad.clone()
    dist.all_reduce(dw)
    res["halo conv"] = {"launches": counts, "ms": ms}
    keep["halo conv"] = {"y": all_gather_cat(y.detach(), None, dim=1).cpu(),
                         "dx": all_gather_cat(xl.grad, None, dim=1).cpu(), "dw": dw.cpu()}
    del x, w, g, xl, wl, y, dw

    # the chunked-alpha CTC, with its gradient
    logits, labels, ll, tl = _p14_ctc_inputs(dev)
    lg = logits[:, rows].contiguous().requires_grad_(True)

    def chunked():
        loss = ctc_loss_seq_parallel(lg, labels, ll, tl, sp)
        loss.sum().backward()
        return loss

    loss, ms = timed(chunked)
    res["chunked ctc"] = {"ms": ms}
    keep["chunked ctc"] = {"loss": loss.detach().cpu(),
                           "dlogits": all_gather_cat(lg.grad, None, dim=1).cpu()}

    # the sharded W = 100 beam eval (and the greedy one) over 13 utterances
    ecfg, ds = _p14_eval_set(_p14_timit("bfloat16"))
    model = create_train_state(ecfg, device=dev).model
    _reset_counts()
    t0 = time.perf_counter()
    beam = evaluate(ecfg, model, ds, beam=True, mesh=sp)
    beam_s = time.perf_counter() - t0
    res["beam"] = {"beam": beam, "beam_s": beam_s, "launches": _read_counts(),
                   "greedy": evaluate(ecfg, model, ds, mesh=sp)}

    with open(os.path.join(directory, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    if rank == 0:
        torch.save(keep, os.path.join(directory, "rank0.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _p14_update_err(got: dict, ref: dict, init: dict) -> dict:
    """_errors of the weights' update (after - before) over every parameter,
    flattened: a data-parallel step against the one-process step."""
    keys = sorted(ref)
    a = torch.cat([(got[k].float() - init[k].float()).reshape(-1) for k in keys])
    b = torch.cat([(ref[k].float() - init[k].float()).reshape(-1) for k in keys])
    return _errors(a, b)


def phase14_parallel(dev: torch.device, smi: str) -> None:
    """Phase 14 in this process: (a) a world of one rank over NCCL through
    the command line under ``torch.distributed.run`` against the same run
    in this process; (b) two ranks sharing the card (gloo, CUDA tensors)
    against the one-process results, computed here first."""
    from qasr_torch.bridge import load_params_npz
    from qasr_torch.configs import get_config
    from qasr_torch.data.batching import epoch_iterator
    from qasr_torch.ops.kernels.qconv_chain import chain_layer
    from qasr_torch.ops.ctc import ctc_loss
    from qasr_torch.train.loop import evaluate, train
    from qasr_torch.train.metrics import state_bytes
    from qasr_torch.train.state import create_train_state
    from qasr_torch.train.step import train_step

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(repo, "qasr_torch", "_build", "smoke_parallel")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    env = {**os.environ, "PYTHONPATH": repo}

    # (a) a world of one rank over NCCL: the command line under
    # torch.distributed.run, then the same run in this process on one device
    sets = {**P14_CLI_SETS, "train.checkpoint_dir": os.path.join(root, "cli")}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "1", "-m", "qasr_torch.cli", "--device", dev.type, "--preset", P14_CLI_PRESET, "--set",
           *[f"{k}={v}" for k, v in sets.items()]]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=repo, env=env, capture_output=True, text=True, timeout=300)
    cli_s = time.perf_counter() - t0
    if p.returncode != 0:
        raise RuntimeError(f"phase 14 torch.distributed.run CLI: rc {p.returncode}\n"
                           f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
    cli_last = json.loads([ln for ln in p.stdout.splitlines() if ln.startswith("{")][-1])
    lcfg = get_config(P14_CLI_PRESET).override(**sets)
    st, one_last = train(lcfg, device=dev, checkpoint_dir=os.path.join(root, "one"))
    del st
    a = load_params_npz(os.path.join(root, "cli", "step_4", "params.npz"))
    b = load_params_npz(os.path.join(root, "one", "step_4", "params.npz"))
    same = a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    if not same or cli_last["loss"] != one_last["loss"]:
        raise RuntimeError(f"phase 14: the NCCL world of one differs from one process "
                           f"(params equal {same}; loss {cli_last['loss']} vs {one_last['loss']})")
    print(f"phase 14 world of one (NCCL, python -m torch.distributed.run --nproc-per-node 1 -m "
          f"qasr_torch.cli, timit_qcnn, 4 steps): params after 4 steps bit-equal to train() in "
          f"one process, loss {cli_last['loss']!r} = {one_last['loss']!r}, dev_per "
          f"{cli_last['dev_per']!r}; {cli_s:.1f} s with the launcher", flush=True)
    torch.cuda.empty_cache()

    # (b) the one-process references, on the same inputs as the ranks'
    ref, init, ref_ms = {}, {}, {}
    for dtype in ("bfloat16", "float32"):
        cfg = _p14_timit(dtype)
        batch = _train_batch(cfg)
        st = create_train_state(cfg, device=dev)
        init[dtype] = {k: v.detach().clone() for k, v in st.model.state_dict().items()}
        m0 = train_step(st, batch)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        m1 = train_step(st, batch)
        e1.record()
        torch.cuda.synchronize()
        ref_ms[dtype] = e0.elapsed_time(e1)
        ref[dtype] = ([m0["loss"].item(), m1["loss"].item()],
                      [m0["grad_norm"].item(), m1["grad_norm"].item()],
                      {k: v.detach().clone() for k, v in st.model.state_dict().items()})
        del st
    cfg5 = _p14_large()
    st = create_train_state(cfg5, device=dev)
    init["large"] = {k: v.detach().clone() for k, v in st.model.state_dict().items()}
    m5 = train_step(st, _p14_large_batch(cfg5))
    whole5, _ = state_bytes(st)
    # each rank's share: the kernels whose Cout 2 divides, halved (the
    # reference's rule), and the rest whole; params and two moments f32, and
    # AdamW's step counts where they lie on the card
    from qasr_torch.parallel.sharding import param_spec

    kern = rest = 0
    for k, v in st.model.named_parameters():
        if param_spec(tuple(k.split(".")), v) and v.shape[-1] % 2 == 0:
            kern += v.numel()
        else:
            rest += v.numel()
    steps = sum(v.numel() * v.element_size() for slot in st.optimizer.state.values()
                for key, v in slot.items() if key == "step" and v.is_cuda)
    want_tp = 4 * 3 * (rest + kern // 2) + steps
    ref["large"] = (m5["loss"].item(), m5["grad_norm"].item(),
                    {k: v.detach().clone() for k, v in st.model.state_dict().items()})
    del st
    x, w, g = _p14_conv_inputs(dev)
    xw = _p14_stack(x).requires_grad_(True)
    ww = w.clone().requires_grad_(True)
    zero = torch.zeros(4 * ww.shape[-1], device=dev)
    y_st = chain_layer(xw, ww.to(torch.bfloat16), zero, None, scheme="fast8")
    from qasr_torch.models.layers import stacked_to_tf_packed

    y_st.backward(_p14_stack(g))
    conv_ref = {"y": stacked_to_tf_packed(y_st.detach()), "dx": stacked_to_tf_packed(xw.grad),
                "dw": ww.grad}
    del x, w, g, xw, ww, y_st
    logits, labels, ll, tl = _p14_ctc_inputs(dev)
    lg = logits.clone().requires_grad_(True)
    ctc_ref = ctc_loss(lg, labels, ll, tl)
    ctc_ref.sum().backward()
    ctc_ref = {"loss": ctc_ref.detach(), "dlogits": lg.grad}
    ecfg, ds = _p14_eval_set(_p14_timit("bfloat16"))
    model = create_train_state(ecfg, device=dev).model
    t0 = time.perf_counter()
    beam_ref = evaluate(ecfg, model, ds, beam=True)
    beam_ref_s = time.perf_counter() - t0
    greedy_ref = evaluate(ecfg, model, ds)
    del model
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # the two ranks, both on this card
    d = os.path.join(root, "ranks")
    os.makedirs(d)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, P14_SCRIPT, "--phase14-rank", str(r),
                               "--phase14-dir", d, "--phase14-device", str(dev)], cwd=repo, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for q in procs:
            logs.append(q.communicate(timeout=max(1.0, P14_TIMEOUT_S - (time.perf_counter() - t0)))[0])
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait()
    ranks_s = time.perf_counter() - t0
    if any(q.returncode != 0 for q in procs):
        raise RuntimeError("phase 14 ranks failed:\n" + "\n".join(
            f"--- rank {r} rc {q.returncode}\n{log[-4000:]}" for r, (q, log) in
            enumerate(zip(procs, logs))))
    res = [json.load(open(os.path.join(d, f"rank{r}.json"))) for r in range(2)]
    got = torch.load(os.path.join(d, "rank0.pt"), map_location=dev, weights_only=True)

    col = res[0]["collectives"]
    for name in ("all_reduce", "broadcast", "all_gather"):
        if col[name] != "ok":
            raise RuntimeError(f"phase 14: gloo {name} on CUDA tensors: {col[name]}")
    print(f"phase 14 collectives (gloo, CUDA tensors, two ranks on one card; torch "
          f"{torch.__version__}): {json.dumps(col)}", flush=True)

    # the update's limits: in bf16 the ranks' partial dW round to bf16 before
    # their sum, where one process rounds the whole sum once, and the PReLU
    # kink turns that into a layer's move (phase 6's TOL_GRAD_BF16); in f32
    # only the two partial sums' order differs (TOL_GRAD_F32, phase 6's f32
    # arithmetic limit), and a fault in the sharded optimizer (weight decay,
    # moments, step count) moves the update far more
    for dtype, tol_loss, tol_upd in (("bfloat16", TOL_LOSS_BF16, TOL_GRAD_BF16),
                                     ("float32", TOL_LOSS_F32, TOL_GRAD_F32)):
        key = f"dp2 {dtype}"
        r_loss, r_norm, r_params = ref[dtype]
        want = _want(qconv_ft8=9, qconv_dx8=9, qgemm8=3, qgemm8_dx=3, qconv_dw_prep=9)
        for r in range(2):
            if res[r][key]["launches"] != want:
                raise RuntimeError(f"phase 14 {key} rank {r}: launches in a step "
                                   f"{res[r][key]['launches']}, expected {want}")
        loss, norm = res[0][key]["loss"], res[0][key]["grad_norm"]
        rel = [abs(a_ - b_) / abs(b_) for a_, b_ in zip(loss + norm, r_loss + r_norm)]
        if not max(rel) <= tol_loss:
            raise RuntimeError(f"phase 14 {key}: loss {loss} / grad norm {norm} against one "
                               f"process {r_loss} / {r_norm} (rel {max(rel):.3e} > {tol_loss})")
        err = _p14_update_err(got[key], r_params, init[dtype])
        _gate(f"phase 14 {key} update", err, tol_upd)
        print(f"phase 14 dp2 {dtype} (timit_qcnn, B16 x T256, two steps, dropout "
              f"{_p14_timit(dtype).model.dropout_rate}): launches a step per rank "
              f"{ {k: v for k, v in res[0][key]['launches'].items() if v} } and "
              f"{ {k: v for k, v in res[1][key]['launches'].items() if v} }; loss {loss} vs one "
              f"process {r_loss}, grad norm {norm} vs {r_norm} (largest rel {max(rel):.3e}, tol "
              f"{tol_loss}); the weights' update rel_norm {err['rel_norm']:.3e} max_rel "
              f"{err['max_rel']:.3e} (tol {tol_upd}); step ms rank 0 "
              f"{res[0][key]['step_ms']:.3f}, rank 1 {res[1][key]['step_ms']:.3f}, one process "
              f"{ref_ms[dtype]:.3f} on {smi} (two ranks sharing one card: says nothing "
              "of scaling across cards)", flush=True)

    r_loss, r_norm, r_params = ref["large"]
    lt = [res[r]["tp2 large"] for r in range(2)]
    for r in range(2):
        c = lt[r]["launches"]
        if not (c["qconv_ft8"] and c["qconv_dx8"] and c["qgemm8"] and c["qgemm8_dx"]
                and c["qconv_dw_prep"]):
            raise RuntimeError(f"phase 14 tp2 large rank {r}: kernels A, C, B, K not all "
                               f"launched {c}")
        if lt[r]["persistent"] != want_tp:
            raise RuntimeError(f"phase 14 tp2 large rank {r}: persistent state "
                               f"{lt[r]['persistent']} bytes, expected {want_tp}")
    rel = max(abs(lt[0]["loss"] - r_loss) / abs(r_loss), abs(lt[0]["grad_norm"] - r_norm) / r_norm)
    if not rel <= TOL_LOSS_BF16:
        raise RuntimeError(f"phase 14 tp2 large: loss {lt[0]['loss']} grad norm "
                           f"{lt[0]['grad_norm']} vs one process {r_loss} {r_norm}")
    err = _p14_update_err(got["tp2 large"], r_params, init["large"])
    # both ranks run the one process's kernels on its rows and whole weights:
    # only the clip norm's sum of squares is grouped otherwise, so the update
    # is held at the kernels' f32 arithmetic limit
    _gate("phase 14 tp2 large update", err, TOL_F32)
    whole_b = sum(whole5.values())
    print(f"phase 14 tp2 librispeech_large (DP 1 x TP 2, B8 x T256, one step, "
          f"{(kern + rest) / 1e6:.2f} M params, {kern / (kern + rest):.1%} of them in sharded "
          f"kernels): per-rank persistent state {lt[0]['persistent']} and {lt[1]['persistent']} "
          f"bytes vs {whole_b} unsharded ({lt[0]['persistent'] / whole_b:.3f}x; the sharded "
          f"kernels with their moments {(4 * 3 * kern // 2) / (4 * 3 * kern):.2f}x), gathered "
          f"kernels {lt[0]['gathered']} bytes beside it; launches rank 0 "
          f"{ {k: v for k, v in lt[0]['launches'].items() if v} }; loss {lt[0]['loss']!r} vs "
          f"{r_loss!r} (bits equal {lt[0]['loss'] == r_loss}), grad norm {lt[0]['grad_norm']!r} "
          f"vs {r_norm!r}; update rel_norm {err['rel_norm']:.3e} max_rel {err['max_rel']:.3e} "
          f"(tol {TOL_F32}); step ms "
          f"{lt[0]['step_ms']:.3f} / {lt[1]['step_ms']:.3f} on {smi} (two ranks on one card)",
          flush=True)

    hc = [res[r]["halo conv"] for r in range(2)]
    for r in range(2):
        if hc[r]["launches"] != _want(qconv_ft8=1, qconv_dx8=1, qconv_dw_prep=1):
            raise RuntimeError(f"phase 14 halo conv rank {r}: launches {hc[r]['launches']}")
    bits = {k: bool(torch.equal(got["halo conv"][k], conv_ref[k])) for k in ("y", "dx", "dw")}
    herr = {k: _errors(got["halo conv"][k], conv_ref[k]) for k in ("y", "dx", "dw")}
    for k in ("y", "dx", "dw"):
        _gate(f"phase 14 halo conv {k}", herr[k], TOL_BF16)
    print(f"phase 14 halo conv (qconv2d_seq_parallel fast8, 256 -> 256, B4 x T256 x F13, T "
          f"split in two, bf16): kernel A 1 and C 1 a rank, against kernel A (and C) over the "
          f"whole T: bits equal {bits}; "
          + ", ".join(f"{k} rel_norm {herr[k]['rel_norm']:.3e} max_rel {herr[k]['max_rel']:.3e}"
                      for k in ("y", "dx", "dw"))
          + f" (dw sums the ranks' parts; tol {TOL_BF16}); forward + backward ms "
          f"{hc[0]['ms']:.3f} / {hc[1]['ms']:.3f}", flush=True)

    errs = {k: _errors(got["chunked ctc"][k], ctc_ref[k]) for k in ("loss", "dlogits")}
    _gate("phase 14 chunked ctc loss", errs["loss"], TOL_CTC_LOSS)
    _gate("phase 14 chunked ctc dlogits", errs["dlogits"], TOL_CTC_GRAD)
    print(f"phase 14 chunked ctc (ctc_loss_seq_parallel, B16 x T256 x V62, ragged, T split in "
          f"two) against ctc_loss: loss rel_norm {errs['loss']['rel_norm']:.3e} max_rel "
          f"{errs['loss']['max_rel']:.3e} (tol {TOL_CTC_LOSS}), dlogits rel_norm "
          f"{errs['dlogits']['rel_norm']:.3e} max_rel {errs['dlogits']['max_rel']:.3e} (tol "
          f"{TOL_CTC_GRAD}); forward + backward ms {res[0]['chunked ctc']['ms']:.1f} / "
          f"{res[1]['chunked ctc']['ms']:.1f}", flush=True)

    n_eval = len(list(epoch_iterator(ds, ecfg.data, train=False)))
    want = _want(qconv_ft8=9 * n_eval, qgemm8=3 * n_eval)  # 9/3 an eval forward
    for r in range(2):
        if res[r]["beam"]["launches"] != want:
            raise RuntimeError(f"phase 14 sharded beam eval rank {r}: launches "
                               f"{res[r]['beam']['launches']}, expected {want}")
    bm = res[0]["beam"]
    for key, want in (("beam", beam_ref), ("greedy", greedy_ref)):
        if bm[key]["per"] != want["per"] or not (
                abs(bm[key]["loss"] - want["loss"]) <= TOL_LOSS_F32 * abs(want["loss"])):
            raise RuntimeError(f"phase 14 sharded {key} eval {bm[key]} vs one process {want}")
    print(f"phase 14 sharded eval (DP 2, 13 utterances in batches of 8, W = 100): launches of "
          f"the beam eval rank 0 { {k: v for k, v in res[0]['beam']['launches'].items() if v} }, "
          f"rank 1 { {k: v for k, v in res[1]['beam']['launches'].items() if v} } ({n_eval} "
          f"batches, 9/3 an eval forward); beam PER "
          f"{bm['beam']['per']!r} = one process {beam_ref['per']!r}, greedy PER "
          f"{bm['greedy']['per']!r} = {greedy_ref['per']!r}; beam eval {bm['beam_s']:.2f} s a "
          f"rank vs {beam_ref_s:.2f} s in one process; two ranks' wall clock {ranks_s:.1f} s; "
          f"phase {time.perf_counter() - t_phase:.1f} s on {smi}", flush=True)
    shutil.rmtree(root, ignore_errors=True)


# config 5's run on mini-LibriSpeech: 400 of the docs' 1200 steps
# (docs/end_to_end.md:103-110), cut to keep the script within its time (the
# 1200 took 95.5 s on an H100, the phase then ~306 s), with evals and
# checkpoints every 200
P15_STEPS = 400
P15_RESUME_STEPS = 20  # the --resume run's further steps
P15_TP_STEPS = 4  # each of the TP-4 run's two halves
P15_TIMEOUT_S = 420  # a subprocess's wall-clock limit
P15_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "qasr_torch", "_build",
                        "smoke_cfg5")
P15_ARMS = ("fast", "fast10", "fast8", "legacy_auto")
# config 5's run: the docs' overrides (B8, 3e-4 after 200 warmup steps) on
# mini-LibriSpeech
P15_SETS = {"data.batch_size": 8, "train.learning_rate": 3e-4, "train.warmup_steps": 200,
            "train.eval_every": 200, "train.checkpoint_every": 200}
P15_CER_MAX = 0.15  # about twice the JAX record at step 400 (0.069)
# a TP-4 rank's persistent state over the unsharded state: the sharded
# kernels (99.9% of the parameters) and their moments a quarter each
P15_TP4_RATIO = (0.25, 0.27)


def _p15_cli(args: list, what: str, torchrun: int = 0) -> str:
    """``python -m <args>`` from the repository's root (under
    ``torch.distributed.run`` with ``torchrun`` ranks when given) as a
    subprocess; its stdout, or a raise with its output."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": repo}
    launcher = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", str(torchrun), "-m"] if torchrun else [sys.executable, "-m"])
    p = subprocess.run([*launcher, *args], cwd=repo, env=env, capture_output=True, text=True,
                       timeout=P15_TIMEOUT_S)
    if p.returncode != 0:
        raise RuntimeError(f"phase 15 {what}: rc {p.returncode}\n{p.stdout[-3000:]}\n"
                           f"{p.stderr[-3000:]}")
    return p.stdout


def _p15_sets(sets: dict) -> list:
    return ["--set", *[f"{k}={v}" for k, v in sets.items()]]


def _p15_rows(directory: str) -> list:
    with open(os.path.join(directory, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def _p15_resumed(directory: str, stdout: str, first: int, last: int, what: str) -> None:
    """Gate a ``--resume`` run: it continued from step ``first`` (its data
    state), reached ``last`` and wrote a data state that moved on."""
    states = [os.path.join(directory, f"data_state_{n}.json") for n in (first, last)]
    if f"resumed from step {first}" not in stdout or not all(map(os.path.exists, states)):
        raise RuntimeError(f"phase 15 {what}: the --resume run did not continue from step "
                           f"{first}:\n{stdout[-2000:]}")
    a, b = (open(s).read() for s in states)
    if a == b:
        raise RuntimeError(f"phase 15 {what}: the data state did not move from step {first} "
                           f"to {last}")


def _p15_remat(dev: torch.device, smi: str, large) -> int:
    """(a) One config-5 step with ``train.remat_convs`` off and on from the
    same weights and batch (B8 x T512): the loss and gradients the same bits
    (a gradient that two runs without remat already differ on is held at
    ``TOL_BF16``), launches (kernel A once a stacked layer either way: remat
    leaves the layers on ``ChainLayerFn`` bare and recomputes the thin one
    alone, as ``segment.recomputes`` and ``segment.bare`` count), peak bytes
    and step ms. Returns the f32 parameters' bytes."""
    from qasr_torch.models import qcnn
    from qasr_torch.tools import memory_envelope
    from qasr_torch.train.state import create_train_state
    from qasr_torch.train.step import batch_to_device, forward_backward, train_step

    t0 = time.perf_counter()
    cfg5 = large.override(**{"data.batch_size": 8, "data.bucket_sizes": (512,)})
    batch = batch_to_device(memory_envelope.point_batch(cfg5, 8, 512), dev)
    init = {k: v.detach().clone()
            for k, v in create_train_state(cfg5, device=dev).model.state_dict().items()}
    param_bytes = _nbytes(*init.values())
    res = {}
    for remat in (False, False, True):
        held = torch.cuda.memory_allocated(dev)  # what lives before this state: its peak's base
        st = create_train_state(cfg5.override(**{"train.remat_convs": remat}), device=dev,
                                params=init)
        _reset_counts()
        qcnn.segment.recomputes = qcnn.segment.bare = 0
        loss = forward_backward(st, batch)
        counts = _read_counts()
        segments = (qcnn.segment.recomputes, qcnn.segment.bare)
        grads = {k: p.grad.detach().clone() for k, p in st.model.named_parameters()}
        if remat in res:  # the second run without remat: its determinism, nothing timed
            res["again"] = {"loss": loss, "grads": grads}
            continue
        train_step(st, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ms = _time_ms(lambda: train_step(st, batch), 3, 1)
        res[remat] = {"loss": loss, "grads": grads, "counts": counts, "segments": segments,
                      "ms": ms, "peak": torch.cuda.max_memory_allocated(dev) - held}
        del st
        torch.cuda.empty_cache()
    want = _want(qconv_ft8=9, qconv_dx8=9, qgemm8=3, qgemm8_dx=3, qconv_dw_prep=9)
    want_segments = {False: (0, 0), True: (1, 9)}
    for remat in (False, True):
        if res[remat]["counts"] != want:
            raise RuntimeError(f"phase 15 remat={remat}: launches {res[remat]['counts']}, "
                               f"expected {want}")
        if res[remat]["segments"] != want_segments[remat]:
            raise RuntimeError(f"phase 15 remat={remat}: segment.recomputes, segment.bare "
                               f"{res[remat]['segments']}, expected {want_segments[remat]}")
    off, on, again = res[False], res[True], res["again"]
    if not torch.equal(off["loss"], on["loss"]):
        raise RuntimeError(f"phase 15 remat: loss {on['loss'].item()!r} vs "
                           f"{off['loss'].item()!r} without remat")
    # a gradient that two runs without remat give in the same bits must be
    # those bits with remat; one that they do not (a non-deterministic
    # library reduction) is held at TOL_BF16 against the first run
    same, loose, worst = 0, [], 0.0
    for k, g in off["grads"].items():
        if torch.equal(g, again["grads"][k]):
            if not torch.equal(on["grads"][k], g):
                raise RuntimeError(f"phase 15 remat: gradient {k} differs with remat, though "
                                   "two runs without remat give the same bits")
            same += 1
        else:
            err = _errors(on["grads"][k], g)
            _gate(f"phase 15 remat grad {k}", err, TOL_BF16)
            loose.append(k)
            worst = max(worst, err["rel_norm"])
    del res, off["grads"], on["grads"], again
    print(f"phase 15 remat (librispeech_large B8 x T512 bf16, one step from the same weights "
          f"and batch): loss {on['loss'].item()!r} both ways (bits equal); {same} gradients "
          f"bit-equal, {len(loose)} non-deterministic without remat too, held at "
          f"{TOL_BF16} (worst rel_norm {worst:.3e}: {loose}); launches a step without remat "
          f"{ {k: v for k, v in off['counts'].items() if v} }, with "
          f"{ {k: v for k, v in on['counts'].items() if v} }; segment.recomputes, segment.bare "
          f"{off['segments']} -> {on['segments']}; peak bytes (the state's and the "
          f"step's, above what lived before) {off['peak']} -> "
          f"{on['peak']} ({on['peak'] / off['peak']:.3f}x); step ms {off['ms']:.3f} -> "
          f"{on['ms']:.3f} ({on['ms'] / off['ms']:.3f}x) on {smi}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return param_bytes


def _p15_envelope(dev: torch.device, smi: str, large) -> None:
    """(b) ``memory_envelope`` at the reference's seven points, with and
    without remat: every row measured or out of memory, remat lower where
    both are measured, B8 x T2048 without remat fits."""
    from qasr_torch.tools import memory_envelope

    t0 = time.perf_counter()
    hbm_gb = torch.cuda.get_device_properties(dev).total_memory / memory_envelope.GB
    points = [tuple(int(v) for v in p.split(":")) for p in memory_envelope.POINTS.split(",")]
    rows = memory_envelope.envelope(large, points, hbm_gb=hbm_gb, device=dev)
    by = {(r["b"], r["t"], r["remat"]): r for r in rows}
    for r in rows:
        if "error" not in r and not r["total_gb"] > r["args_gb"] > 0:
            raise RuntimeError(f"phase 15 envelope: row {r}")
        if "error" in r and "out of memory" not in r["error"].lower():
            raise RuntimeError(f"phase 15 envelope: row {r}")
    for b, t in points:
        r0, r1 = by[(b, t, False)], by[(b, t, True)]
        if "error" not in r0 and "error" not in r1 and not r1["total_gb"] < r0["total_gb"]:
            raise RuntimeError(f"phase 15 envelope B{b} T{t}: remat {r1['total_gb']:.3f} GB "
                               f"not below {r0['total_gb']:.3f} GB")
    if not by[(8, 2048, False)].get("fits"):
        raise RuntimeError(f"phase 15 envelope: B8 x T2048 without remat does not fit: "
                           f"{by[(8, 2048, False)]}")
    print(f"phase 15 envelope (python -m qasr_torch.tools.memory_envelope, librispeech_large, "
          f"bf16, one warmed-up train step a point, peak torch.cuda.max_memory_allocated) on "
          f"{smi}, {hbm_gb:.1f} GB: " + "; ".join(
              memory_envelope.format_row(r, hbm_gb)
              + ("" if "error" in r else f" {r['step_ms']:.1f} ms") for r in rows)
          + f"; {time.perf_counter() - t0:.1f} s", flush=True)


def _p15_run(dev: torch.device, smi: str, large) -> str:
    """(c) The docs' config-5 run on mini-LibriSpeech through the command
    line (streaming, B8, dev-clean evals): the loss falls, the ``best.json``
    step's CER, ``--resume`` from the last data state, a ``transcribe
    --beam`` of one dev utterance; then, not gated, featurization, a
    corpus step and its profile. Returns the corpus's directory."""
    import contextlib
    import io

    from qasr_torch import cli
    from qasr_torch.data.batching import BatchStream, Prefetcher
    from qasr_torch.data.pipeline import LibriFeaturePipeline
    from qasr_torch.tools import make_mini_librispeech
    from qasr_torch.train.state import create_train_state
    from qasr_torch.train.step import train_step

    root = P15_ROOT
    t0 = time.perf_counter()
    libri = os.path.join(root, "libri")
    written = make_mini_librispeech.write_corpus(libri, speakers=8, utts_per_speaker=12,
                                                 dev_speakers=4, seed=SEED)
    run = os.path.join(root, "run")
    sets = {**P15_SETS, "data.data_dir": libri, "train.checkpoint_dir": run}
    _reset_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["--preset", "librispeech_large",
                  *_p15_sets({**sets, "train.num_steps": P15_STEPS})])
    train_s = time.perf_counter() - t0
    counts = _read_counts()
    rows = _p15_rows(run)
    losses = [(r["step"], r["loss"]) for r in rows if "loss" in r]
    evals = {r["step"]: r["dev_per"] for r in rows if "dev_per" in r}
    rates = [r["audio_s_per_s_per_chip"] for r in rows if "audio_s_per_s_per_chip" in r]
    with open(os.path.join(run, "best.json")) as f:
        best = json.load(f)["step"]
    if not (losses[-1][1] < losses[0][1] and all(math.isfinite(v) for _, v in losses)):
        raise RuntimeError(f"phase 15 config 5: the loss did not fall: {losses}")
    if not evals[best] <= P15_CER_MAX:
        raise RuntimeError(f"phase 15 config 5: dev CER {evals[best]} at the best step {best} "
                           f"exceeds {P15_CER_MAX} ({evals})")
    if not (counts["qconv_ft8"] and counts["qconv_dx8"] and counts["qgemm8"]
            and counts["qgemm8_dx"] and counts["qconv_dw_prep"]):
        raise RuntimeError(f"phase 15 config 5: kernels A, C, B, K not all launched: {counts}")
    t1 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["--preset", "librispeech_large", "--resume",
                  *_p15_sets({**sets, "train.num_steps": P15_STEPS + P15_RESUME_STEPS,
                              "train.checkpoint_every": P15_RESUME_STEPS})])
    resume_s = time.perf_counter() - t1
    _p15_resumed(run, out.getvalue(), P15_STEPS, P15_STEPS + P15_RESUME_STEPS, "config 5")
    resumed = [r["loss"] for r in _p15_rows(run) if "loss" in r and r["step"] > P15_STEPS]
    if not resumed or not all(math.isfinite(v) for v in resumed):
        raise RuntimeError(f"phase 15 config 5: the resumed run's losses {resumed}")
    dev_dir = os.path.join(libri, "dev-clean", "900", "1")
    wav = os.path.join(dev_dir, "900-1-0000.wav")
    with open(os.path.join(dev_dir, "900-1.trans.txt")) as f:
        ref_text = f.readline().split(" ", 1)[1].strip()
    said = _p15_cli(["qasr_torch.cli", "transcribe", "--ckpt", run, "--step", str(best),
                     "--beam", wav], "transcribe --beam")
    text = said.strip().splitlines()[-1].partition("\t")[2]
    if not text.strip():
        raise RuntimeError(f"phase 15 transcribe --beam: empty transcript:\n{said}")
    # not gated: streaming featurization, a corpus step, its idle share
    ccfg = large.override(**{**sets, "train.num_steps": P15_STEPS})
    pipe = LibriFeaturePipeline(ccfg, "train-clean-100", device=dev)
    audio_s = sum(len(pipe.corpus.load(i)[0]) for i in range(len(pipe))) / ccfg.data.sample_rate
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pipe.prefetch(range(len(pipe)))
    feat_s = time.perf_counter() - t1
    st = create_train_state(ccfg, device=dev)
    pf = Prefetcher(BatchStream(LibriFeaturePipeline(ccfg, "train-clean-100", device=dev),
                                ccfg.data, seed=SEED), depth=2)
    try:
        corpus_batch = next(pf)[0]
        for _ in range(3):
            train_step(st, corpus_batch)
        step_ms = _time_ms(lambda: train_step(st, corpus_batch), 5, 1)
        for _ in range(2):
            train_step(st, next(pf)[0])
        prof = _profile(lambda: train_step(st, next(pf)[0]), "one config-5 train step on "
                        "mini-LibriSpeech, streaming, fed by the prefetch thread", 15, smi, 3)
    finally:
        pf.close()
    n_train = len(pipe)
    del st, pipe
    torch.cuda.empty_cache()
    b_frames = corpus_batch["features"].shape[1]
    print(f"phase 15 config 5 (python -m qasr_torch.cli --preset librispeech_large, "
          f"mini-LibriSpeech {written} utterances, streaming, B8, 3e-4 after 200 warmup steps): "
          f"{P15_STEPS} steps (of the docs' 1200: cut for time) in {train_s:.1f} s, loss "
          f"{losses[0]} -> {losses[-1]}, dev CER "
          f"{ {k: round(v, 4) for k, v in sorted(evals.items())} }, best.json step {best} CER "
          f"{evals[best]:.4f} (limit {P15_CER_MAX}); launches "
          f"{ {k: v for k, v in counts.items() if v} }; --resume to step "
          f"{P15_STEPS + P15_RESUME_STEPS} from data_state_{P15_STEPS}.json in {resume_s:.1f} s, "
          f"losses {[round(v, 6) for v in resumed]}; transcribe --beam of {os.path.basename(wav)} "
          f"at step {best}: {text!r} (reference {ref_text!r})", flush=True)
    print(f"phase 15 config 5 timing on {smi}: streaming featurization of train-clean-100 "
          f"({n_train} utterances, "
          f"{audio_s:.1f} audio-s) {feat_s:.3f} s ({audio_s / feat_s:.1f} audio-s/s); a corpus "
          f"train step B8 x T{b_frames} {step_ms:.3f} ms; the loop's audio_s_per_s_per_chip "
          f"median {float(np.median(rates)):.1f} (min {min(rates):.1f}, max {max(rates):.1f}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(prof, flush=True)
    return libri


def _p15_tp4(smi: str, libri: str, param_bytes: int) -> None:
    """(d) Config 5 at TP 4 through ``torch.distributed.run`` on the one
    card (the CLI picks gloo): 4 steps, ``--resume``, 4 more; the losses
    finite, a rank's persistent state 0.25-0.27x the unsharded, the data
    state continued."""
    root = P15_ROOT
    t0 = time.perf_counter()
    tp = os.path.join(root, "tp4")
    tsets = {"data.data_dir": libri, "data.batch_size": 8, "train.log_every": 1,
             "train.eval_every": 1000, "train.checkpoint_every": P15_TP_STEPS,
             "train.checkpoint_dir": tp, "train.warmup_steps": 2, "train.learning_rate": 1e-4}
    _p15_cli(["qasr_torch.cli", "--preset", "librispeech_large",
                      *_p15_sets({**tsets, "train.num_steps": P15_TP_STEPS})],
                     "TP 4", torchrun=4)
    second = _p15_cli(["qasr_torch.cli", "--preset", "librispeech_large", "--resume",
                       *_p15_sets({**tsets, "train.num_steps": 2 * P15_TP_STEPS})],
                      "TP 4 --resume", torchrun=4)
    _p15_resumed(tp, second, P15_TP_STEPS, 2 * P15_TP_STEPS, "TP 4")
    trows = _p15_rows(tp)
    tlosses = [(r["step"], r["loss"]) for r in trows if "loss" in r]
    if [s for s, _ in tlosses] != list(range(1, 2 * P15_TP_STEPS + 1)) or not all(
            math.isfinite(v) for _, v in tlosses):
        raise RuntimeError(f"phase 15 TP 4: losses {tlosses}")
    whole = 3 * param_bytes  # the f32 parameters and AdamW's two moments
    per_rank = [r["state_bytes_per_device_max"] for r in trows
                if "state_bytes_per_device_max" in r]
    ratio = max(per_rank) / whole
    if not P15_TP4_RATIO[0] <= ratio <= P15_TP4_RATIO[1]:
        raise RuntimeError(f"phase 15 TP 4: a rank's persistent state {per_rank} bytes is "
                           f"{ratio:.4f}x the unsharded {whole}")
    step_s = [r["step_time_s"] for r in trows if "loss" in r and r["step"] > 1]
    print(f"phase 15 tp4 (python -m torch.distributed.run --nproc-per-node 4 -m qasr_torch.cli "
          f"--preset librispeech_large: mesh.model_axis=4, four ranks on one card over gloo, "
          f"streaming, B8): losses {[round(v, 4) for _, v in tlosses]} (steps 1-"
          f"{2 * P15_TP_STEPS}, --resume after {P15_TP_STEPS} from its data state); a rank's "
          f"persistent state {max(per_rank)} bytes vs {whole} unsharded ({ratio:.4f}x, limits "
          f"{P15_TP4_RATIO}); step s {[round(v, 3) for v in step_s]} (four ranks sharing one "
          f"card's SMs, gloo through the host: says nothing of scaling); "
          f"{time.perf_counter() - t0:.1f} s on {smi}", flush=True)


def _p15_arms(dev: torch.device, smi: str) -> float:
    """(e) ``timit_qcnn`` at full width on each packed XLA conv arm: the
    logits against the f32 plain path (``TOL_LOGITS_F32``) and against the
    rank-8 path (two bf16 paths, ``TOL_LOGITS``), one step's bf16 gradients
    against the same arm in f32, launches (B only); then the step ms.
    Returns the rank-8 step's ms."""
    from qasr_torch.configs import get_config
    from qasr_torch.models import build_model
    from qasr_torch.train.state import create_train_state
    from qasr_torch.train.step import batch_to_device, loss_fn, train_step

    t0 = time.perf_counter()
    tcfg = get_config("timit_qcnn").override(**TRAIN_OVERRIDES)
    tbatch = _train_batch(tcfg)
    feats = torch.from_numpy(tbatch["features"]).to(dev)
    base = build_model(tcfg, generator=torch.Generator().manual_seed(SEED), device=dev)
    weights = {k: v.detach().clone() for k, v in base.state_dict().items()}
    with torch.no_grad():
        ref = base(feats)
        f32 = build_model(tcfg.override(**{"model.compute_dtype": "float32"}), device=dev)
        f32.load_state_dict(weights)
        ref32 = f32(feats, plain=True)
    del base, f32
    e_base = _errors(ref, ref32)
    st = create_train_state(tcfg, device=dev, params=weights)
    arm_ms = {"auto": _time_ms(lambda: train_step(st, tbatch), 3, 1)}
    del st
    summary = []
    for arm in P15_ARMS:
        acfg = tcfg.override(**{"model.op_variant": arm})
        model = build_model(acfg, device=dev)
        model.load_state_dict(weights)
        _reset_counts()
        with torch.no_grad():
            logits = model(feats)
        fwd_counts = _read_counts()
        if fwd_counts != _want(qgemm8=3):
            raise RuntimeError(f"phase 15 {arm} forward: launches {fwd_counts}")
        # each bf16 path against the f32 plain path (phase 4's limit), and
        # two bf16 paths against each other (phase 4's kernel vs plain limit)
        e_rank8, e_f32 = _errors(logits, ref), _errors(logits, ref32)
        _gate(f"phase 15 {arm} logits vs f32 plain", e_f32, TOL_LOGITS_F32)
        _gate(f"phase 15 {arm} logits vs the rank-8 path", e_rank8, TOL_LOGITS)
        del model
        # one step's gradients against the same arm in f32, dropout off
        got = {}
        for dtype in ("bfloat16", "float32"):
            gcfg = acfg.override(**{"model.compute_dtype": dtype, "model.dropout_rate": 0.0})
            st = create_train_state(gcfg, device=dev, params=weights)
            b = batch_to_device(tbatch, dev)
            _reset_counts()
            loss = loss_fn(gcfg, st.model(b["features"], generator=st.generator), b)
            loss.backward()
            got[dtype] = (loss.item(), _read_counts(),
                          {k: p.grad.float() for k, p in st.model.named_parameters()})
            del st
        step_counts = got["bfloat16"][1]
        if step_counts != _want(qgemm8=3, qgemm8_dx=3):
            raise RuntimeError(f"phase 15 {arm} step: launches {step_counts}")
        dl = abs(got["bfloat16"][0] - got["float32"][0]) / abs(got["float32"][0])
        if not dl <= TOL_LOSS_BF16:
            raise RuntimeError(f"phase 15 {arm}: loss bf16 {got['bfloat16'][0]} f32 "
                               f"{got['float32'][0]}")
        worst = 0.0
        for k, g in got["float32"][2].items():
            err = _errors(got["bfloat16"][2][k], g)
            _gate(f"phase 15 {arm} grad {k}", err, TOL_GRAD_BF16)
            worst = max(worst, err["rel_norm"])
        del got
        st = create_train_state(acfg, device=dev, params=weights)
        arm_ms[arm] = _time_ms(lambda: train_step(st, tbatch), 3, 1)
        del st
        torch.cuda.empty_cache()
        summary.append(f"{arm}: logits vs rank-8 rel_norm {e_rank8['rel_norm']:.3e} max_rel "
                       f"{e_rank8['max_rel']:.3e}, vs f32 plain {e_f32['rel_norm']:.3e} / "
                       f"{e_f32['max_rel']:.3e}; loss bf16 vs f32 rel {dl:.3e}, worst grad "
                       f"rel_norm {worst:.3e}")
    print(f"phase 15 packed arms (timit_qcnn full width, op_variant "
          f"{' | '.join(P15_ARMS)}: every layer packed, cuDNN convs, no conv kernel; launches a "
          f"forward B 3, a step B 3 + 3, A and C 0; the rank-8 path vs f32 plain rel_norm "
          f"{e_base['rel_norm']:.3e} max_rel {e_base['max_rel']:.3e}): " + "; ".join(summary)
          + f" (tol logits vs f32 plain {TOL_LOGITS_F32}, vs rank-8 {TOL_LOGITS}, grads "
          f"{TOL_GRAD_BF16}, loss {TOL_LOSS_BF16})",
          flush=True)
    print(f"phase 15 packed arms timing on {smi}: train step B16xT256 bf16 ms "
          + ", ".join(f"{k} {v:.3f}" for k, v in arm_ms.items())
          + f"; {time.perf_counter() - t0:.1f} s", flush=True)
    return arm_ms["auto"]


def _p15_scaling(smi: str, rank8_ms: float) -> None:
    """(f) ``run_scaling_table`` in a world of one (NCCL): one row,
    efficiency 1.0."""
    t0 = time.perf_counter()
    said = _p15_cli(["qasr_torch.tools.run_scaling_table"], "run_scaling_table",
                    torchrun=1)
    line = json.loads([ln for ln in said.splitlines() if ln.startswith("{")][-1])
    row = line["rows"][0] if len(line["rows"]) == 1 else None
    if (row is None or row["efficiency"] != 1.0 or not row["step_ms"] > 0
            or line["backend"] != "cuda"):
        raise RuntimeError(f"phase 15 scaling table: {line}")
    print(f"phase 15 scaling table (python -m torch.distributed.run --nproc-per-node 1 -m "
          f"qasr_torch.tools.run_scaling_table, NCCL): {json.dumps(line)}; train step "
          f"{row['step_ms']} ms beside the packed arms' auto {rank8_ms:.3f} ms; "
          f"{time.perf_counter() - t0:.1f} s on {smi}", flush=True)


def phase15_config5(dev: torch.device, smi: str) -> None:
    """Config 5 (``librispeech_large``: conv 64..256 x 10, dense 1024 x 3,
    36.2 M parameters, bf16, the rank-8 chain on kernels A and C, the dense
    layers on B) end to end with its tools, and the packed XLA conv arms:
    (a) :func:`_p15_remat`, (b) :func:`_p15_envelope`, (c) :func:`_p15_run`,
    (d) :func:`_p15_tp4`, (e) :func:`_p15_arms`, (f) :func:`_p15_scaling`."""
    from qasr_torch.configs import get_config

    t_phase = time.perf_counter()
    shutil.rmtree(P15_ROOT, ignore_errors=True)
    os.makedirs(P15_ROOT)
    large = get_config("librispeech_large")
    param_bytes = _p15_remat(dev, smi, large)
    _p15_envelope(dev, smi, large)
    libri = _p15_run(dev, smi, large)
    _p15_tp4(smi, libri, param_bytes)
    shutil.rmtree(P15_ROOT, ignore_errors=True)
    rank8_ms = _p15_arms(dev, smi)
    _p15_scaling(smi, rank8_ms)
    print(f"phase 15 {time.perf_counter() - t_phase:.1f} s on {smi}", flush=True)

def time_kernels(tree: str) -> int:
    """``--time-kernels TREE``: of the ``qasr_torch`` under ``TREE``, bf16, on
    CUDA events: the conv kernels at phase 5's shape, the rank-8 A (with its
    PReLU prologue and bias) and C (with and without its PReLU-backward
    epilogue) and the 10-product F and G likewise, each as the wrapper's
    call and as the launcher alone on ready weight combos (A and F also
    without the prologue); A and C at config 4's three stacked shapes (B32
    F13 T512, as its train step calls them) with cuDNN's ``F.conv2d`` on the
    expanded (adjoint) weight and A's plain version beside them; kernels B
    and H, forward and dx, at every path shape (config 2's dense layers at
    M4096 K3328 and K256, config 4's M16384 K512 N256 (B's dx too) and M2048
    K1664 N2048 for B, the im2col convs' M53248 K2304 for H), each as the
    wrapper's call and as the launcher alone on ready inputs (B at config
    4's shapes also as its plain version), and ``torch.matmul`` on the Hamilton-expanded weight for
    B at config 4's M16384 K512 N256 and B's dx at M4096 N256 -> K256;
    kernel I at phase 9's three shapes; kernel J at the probe's shape in
    both modes, on CUDA events and in CUDA-graph replays, with
    ``torch.matmul(x.T, y)`` beside it; kernels D and E at config 4's shape
    (T512 B32 H256, both directions, ragged lengths), the launchers alone on
    ready inputs; and the rank-8, 10-product and ``use_pallas`` train steps
    (B16 x T256), config 4's (B32 x T512, ragged) and config 4's encoder
    forward (B32 x T512). One JSON line of ms, and how many outputs of A, C
    and B in the rank-8 combo check (:func:`_combo_mismatches`) differ (I's
    entries name its split S where the tree has one). Run for two trees in
    turns (parent, change, change, parent) in one call on the card, it
    compares two commits' kernels; each tree builds its own at first use."""
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import qasr_torch
    from qasr_torch import qconv_dx8, qconv_ft8
    from qasr_torch.configs import get_config
    from qasr_torch.infer import Transcriber
    from qasr_torch.models import build_model
    from qasr_torch.ops.initializers import quaternion_init
    from qasr_torch.ops.kernels import qgemm, qlstm_scan
    from qasr_torch.ops.kernels import qconv_ft as qconv_ft_mod
    from qasr_torch.ops.kernels import qgemm8 as qgemm8_mod
    from qasr_torch.ops.kernels.dgt import dgt
    from qasr_torch.ops.kernels.qconv_dx import conj_transpose_w, qconv_dx10, qconv_dx_cuda
    from qasr_torch.ops.kernels.qconv_ft import SCHEME8, SCHEME10, qconv_ft10, qconv_ft_cuda
    from qasr_torch.ops.kernels.qgemm8 import (
        conj_transpose_dense,
        qgemm8_cl,
        qgemm8_cuda,
        qgemm8_dx,
    )
    from qasr_torch.ops.quaternion import U8, W_COMBO, combine_weights, hamilton_expand
    from qasr_torch.train.state import create_train_state
    from qasr_torch.train.step import train_step

    if not os.path.abspath(qasr_torch.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {qasr_torch.__file__}, not the tree {tree}")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    bf16 = torch.bfloat16
    x = rnd(16, 4, 13, 256, 256, scale=0.5).to(bf16)
    dz = rnd(16, 4, 13, 256, 256).to(bf16)
    w = rnd(4, 3, 3, 256, 256, scale=0.02)
    bias, alpha, slopes = rnd(1024, scale=0.1), rnd(1024, scale=0.25).abs(), rnd(1024, scale=0.25)
    times = {}
    # A, C, F and G: the wrapper's call (its weight combos included) and the
    # launcher alone on ready combos
    for sc, fwd, bwd, name in ((SCHEME8, qconv_ft8, qconv_dx8, "8"),
                               (SCHEME10, qconv_ft10, qconv_dx10, "10")):
        wc_f = combine_weights(w, bf16, sc.u).contiguous()
        wc_g = combine_weights(conj_transpose_w(w), bf16, sc.u).contiguous()
        for label, call, alone in (
            (f"qconv_ft{name} B16 F13 T256 C256 prologue+bias", lambda: fwd(x, w, bias, alpha),
             lambda: qconv_ft_cuda(x, wc_f, bias, alpha, scheme=sc)),
            (f"qconv_dx{name} B16 F13 T256 C256", lambda: bwd(dz, w),
             lambda: qconv_dx_cuda(dz, wc_g, scheme=sc)),
            (f"qconv_dx{name} B16 F13 T256 C256 epilogue", lambda: bwd(dz, w, x, slopes),
             lambda: qconv_dx_cuda(dz, wc_g, x, slopes, scheme=sc)),
        ):
            times[label] = _time_ms(call, 20, 3)
            times[f"{label} alone"] = _time_ms(alone, 20, 3)
        times[f"qconv_ft{name} B16 F13 T256 C256 alone"] = _time_ms(
            lambda: qconv_ft_cuda(x, wc_f, scheme=sc), 20, 3)
        del wc_f, wc_g
    del x, dz
    # A and C at config 4's stacked shapes as its train step calls them (the
    # first stacked layer without the PReLU prologue and backward), and
    # cuDNN's F.conv2d on the Hamilton-expanded (adjoint) weight over the
    # packed NCHW input
    for cin, cout in ((64, 64), (64, 128), (128, 128)):
        first = (cin, cout) == (64, 64)
        w4 = rnd(4, 3, 3, cin, cout, scale=(9 * cin) ** -0.5)
        x4 = rnd(32, 4, 13, 512, cin, scale=0.5).to(bf16)
        dz4 = rnd(32, 4, 13, 512, cout).to(bf16)
        b4, a4, s4 = rnd(4 * cout, scale=0.1), rnd(4 * cin, scale=0.25).abs(), rnd(4 * cin, scale=0.25)
        pro, epi = (None, None) if first else (a4, (x4, s4))
        shape = f"B32 F13 T512 C{cin}->{cout}"
        times[f"qconv_ft8 {shape}"] = _time_ms(lambda: qconv_ft8(x4, w4, b4, pro), 10, 3)
        times[f"qconv_ft8 {shape} plain"] = _time_ms(
            lambda: qconv_ft_mod.qconv_stacked_plain(x4, w4, b4, pro), 3, 1)
        times[f"qconv_dx8 {shape}"] = _time_ms(
            lambda: qconv_dx8(dz4, w4, *(epi or (None, None))), 10, 3)
        x_lib = x4.permute(0, 1, 4, 2, 3).reshape(32, 4 * cin, 13, 512).contiguous()
        w_lib = hamilton_expand(w4).permute(3, 2, 1, 0).contiguous().to(bf16)
        times[f"qconv_ft8 {shape} library"] = _time_ms(
            lambda: F.conv2d(x_lib, w_lib, padding=1), 10, 3)
        dz_lib = dz4.permute(0, 1, 4, 2, 3).reshape(32, 4 * cout, 13, 512).contiguous()
        wt_lib = hamilton_expand(conj_transpose_w(w4)).permute(3, 2, 1, 0).contiguous().to(bf16)
        times[f"qconv_dx8 {shape} library"] = _time_ms(
            lambda: F.conv2d(dz_lib, wt_lib, padding=1), 10, 3)
        del w4, x4, dz4, x_lib, w_lib, dz_lib, wt_lib
    torch.cuda.empty_cache()
    # library calls of rows 4 and 4b: one torch.matmul on the Hamilton-
    # expanded (adjoint) weight over the packed input
    for label, m, k, n, role in (("qgemm8 M16384 K512 N256 library", 16384, 512, 256, "fwd"),
                                 ("qgemm8_dx M4096 N256 -> K256 library", 4096, 256, 256, "dx")):
        wg = rnd(4, k, n, scale=k ** -0.5)
        w_lib = hamilton_expand(wg if role == "fwd" else conj_transpose_dense(wg)).to(bf16)
        inp = rnd(m, w_lib.shape[0], scale=0.5).to(bf16)
        times[label] = _time_ms(lambda: torch.matmul(inp, w_lib), 20, 3)
        del wg, w_lib, inp
    # B and H: (kernel, M, K, N, roles); dx maps [4, M, N] -> [4, M, K]
    gemms = [("qgemm8", 4096, 3328, 256, ("fwd", "dx")), ("qgemm8", 4096, 256, 256, ("fwd", "dx")),
             ("qgemm8", 16384, 512, 256, ("fwd", "dx")), ("qgemm8", 2048, 1664, 2048, ("fwd",)),
             ("qgemm10", 4096, 3328, 256, ("fwd", "dx")), ("qgemm10", 4096, 256, 256, ("fwd", "dx")),
             ("qgemm10", 53248, 2304, 256, ("fwd", "dx"))]
    for name, m, k, n, roles in gemms:
        wg = rnd(4, k, n, scale=k ** -0.5)
        table, launcher = (U8, qgemm8_cuda) if name == "qgemm8" else (W_COMBO, qgemm.qgemm10_cuda)
        calls = {"fwd": qgemm8_cl if name == "qgemm8" else qgemm.qgemm10,
                 "dx": qgemm8_dx if name == "qgemm8" else qgemm.qgemm10_dx}
        reps = 5 if m > 4096 else 20
        for role in roles:
            inp = rnd(4, m, k if role == "fwd" else n, scale=0.5).to(bf16)
            wr = wg if role == "fwd" else conj_transpose_dense(wg)
            wc = combine_weights(wr, bf16, table).contiguous()
            shape = f"M{m} K{k} N{n}" if role == "fwd" else f"M{m} N{n} -> K{k}"
            label = f"{name} {shape}" if role == "fwd" else f"{name}_dx {shape}"
            times[label] = _time_ms(lambda: calls[role](inp, wg), reps, 3)
            times[f"{label} alone"] = _time_ms(lambda: launcher(inp, wc, role=role), reps, 3)
            if name == "qgemm8" and m != 4096:  # config 4's shapes: the plain version too
                times[f"{label} plain"] = _time_ms(
                    lambda: qgemm8_mod.qgemm8_cl_plain(inp, wr), reps, 3)
            del inp, wc
        del wg
        torch.cuda.empty_cache()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for m, k, n in ((4096, 3328, 256), (4096, 256, 256), (53248, 2304, 256)):
        xg, dyg = rnd(4, m, k, scale=0.5).to(bf16), rnd(4, m, n).to(bf16)
        split = (f" S{qgemm.dw_splits(m, k, n, bf16, sms)}" if hasattr(qgemm, "dw_splits")
                 else "")
        times[f"qgemm10_dw M{m} K{k} N{n}{split}"] = _time_ms(lambda: qgemm.qgemm10_dw(xg, dyg),
                                                              5 if m > 4096 else 20, 3)
        del xg, dyg
    torch.cuda.empty_cache()
    # kernel J at the probe's shape, both modes: the wrapper's call on CUDA
    # events and in CUDA-graph replays, and torch.matmul(x.T, y) beside it
    xj, yj = rnd(65536, 256).to(bf16), rnd(65536, 256).to(bf16)
    xj_t = xj.T.contiguous()
    for arm, call in (("mode dgt", lambda: dgt(xj, yj, mode="dgt")),
                      ("mode plain", lambda: dgt(xj_t, yj, mode="plain")),
                      ("library", lambda: torch.matmul(xj.T, yj))):
        times[f"dgt M65536 K256 N256 {arm}"] = _time_ms(call, 50, 3)
        times[f"dgt M65536 K256 N256 {arm} graph"] = _graph_ms(call, 30)
    del xj, yj, xj_t
    # kernels D and E at config 4's shape, the launchers alone; E on the
    # residuals of D's plain version
    cfg4 = get_config("librispeech_qlstm")
    t4, b4, h4 = cfg4.data.bucket_sizes[0], cfg4.data.batch_size, cfg4.model.lstm_features
    lens = torch.randint(t4 // 4, t4 + 1, (b4,), generator=g, device=dev)
    lens[0] = t4
    xz = rnd(t4, 2, b4, 16 * h4, scale=0.5).to(bf16)
    dhs = rnd(t4, 2, b4, 4 * h4).to(bf16)
    wc = torch.stack([combine_weights(quaternion_init(
        (4, h4, 4 * h4), generator=torch.Generator().manual_seed(SEED + d), device=dev))
        for d in range(2)]).to(bf16)
    _, cs, gates = qlstm_scan.qlstm_scan_fwd_plain(xz, wc, lens)
    shape = f"T{t4} B{b4} H{h4} D2 ragged"
    times[f"qlstm_scan8 {shape} alone"] = _time_ms(
        lambda: qlstm_scan.qlstm_scan_cuda(xz, wc, lens), 20, 3)
    times[f"qlstm_scan8_bwd {shape} alone"] = _time_ms(
        lambda: qlstm_scan.qlstm_scan_bwd_cuda(wc, gates, cs, dhs, lens), 20, 3)
    del xz, dhs, wc, cs, gates
    # config 4's encoder forward, as phase 7 times it
    params = build_model(cfg4, generator=torch.Generator().manual_seed(SEED),
                         device=dev).state_dict()
    enc = Transcriber(cfg=cfg4, params=params, device=dev).model
    with torch.no_grad():
        feats = rnd(b4, t4, cfg4.data.n_mels, 4)
        full = torch.full((b4,), t4, device=dev)
        times[f"encoder forward config 4 B{b4} T{t4}"] = _time_ms(
            lambda: enc(feats, lengths=full), 5, 2)
    del params, enc, feats
    torch.cuda.empty_cache()
    tcfg8 = get_config("timit_qcnn").override(**TRAIN_OVERRIDES)
    tcfg = tcfg8.override(**{"model.op_variant": "fused", "model.dense_variant": "pallas"})
    batch = _train_batch(tcfg)
    for name, cfg in (("rank-8", tcfg8), ("10-product", tcfg), ("use_pallas", tcfg.override(**{
            "model.use_pallas": True}))):
        state = create_train_state(cfg, device=dev)
        times[f"train step {name} B16 T256"] = _time_ms(lambda: train_step(state, batch), 3, 2)
        del state
        torch.cuda.empty_cache()
    tcfg4, batch4 = _qlstm_train_batch(get_config("librispeech_qlstm"))
    state = create_train_state(tcfg4, device=dev)
    times["train step config 4 B32 T512"] = _time_ms(lambda: train_step(state, batch4), 3, 2)
    del state
    torch.cuda.empty_cache()
    _line(tree=tree, combos_differing=_combo_mismatches(dev), **times)
    return 0


def phase5_kernel_k(xa: torch.Tensor, dza: torch.Tensor, alpha: torch.Tensor,
                    smi: str) -> dict:
    """Kernel K at phase 5's layer (``xa``, ``dza``: B16 F13 T256 256->256
    bf16) in ``fast8``, with the previous layer's PReLU of ``alpha`` and
    without: the input and output combos bit for bit against its plain
    version's and db within ``TOL_DB`` (gated); K and its plain version in
    turns (CUDA events). Returns the ``kernels`` entry of the PReLU case
    with its launches left to fill; its bound is the bytes: x, dz and the slopes read
    once, the 2P combos and db written."""
    from qasr_torch.ops.kernels.qconv_dw_prep import qconv_dw_prep, qconv_dw_prep_plain
    from qasr_torch.ops.kernels.qconv_ft import SCHEME8

    def bits(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)

    scale = dza.float().abs().sum(dim=(0, 2, 3)).reshape(-1)
    rows = {}
    for what, a in (("with the PReLU", alpha), ("without the PReLU", None)):
        got = qconv_dw_prep(xa, dza, a, scheme=SCHEME8)
        want = qconv_dw_prep_plain(xa, dza, a, scheme=SCHEME8)
        for part, g, w in zip(("input combos", "output combos"), got[:2], want[:2]):
            if g.shape != w.shape or not torch.equal(bits(g), bits(w)):
                raise RuntimeError(f"kernel K {what}: its {part} are not its plain version's "
                                   f"bits")
        err = _errors(got[2], want[2])
        worst = ((got[2] - want[2]).abs() / scale).max().item()
        if not worst <= TOL_DB:
            raise RuntimeError(f"kernel K {what}: db off its plain version's by {worst:.3e} "
                               f"of a channel's sum of magnitudes (limit {TOL_DB:.0e})")
        ms = _alternating(lambda a=a: qconv_dw_prep(xa, dza, a, scheme=SCHEME8),
                          lambda a=a: qconv_dw_prep_plain(xa, dza, a, scheme=SCHEME8), 20, 5)
        rows[what] = (ms, err, worst)
    n_prods = SCHEME8.n_prods
    nbytes = (_nbytes(xa, dza, alpha) + n_prods * (xa.numel() + dza.numel()) // 4
              * xa.element_size() + 4 * dza.shape[-1] * 4)
    bound = _bound(0.0, nbytes)
    (k_ms, p_ms), err, _ = rows["with the PReLU"]
    b, _, nf, t, cin = xa.shape
    print(f"phase 5 kernel K on {smi}: B{b} F{nf} T{t} {cin}->{dza.shape[-1]} {xa.dtype} fast8, "
          f"bound {bound[0]:.4f} ms ({nbytes / 1e9:.3f} GB); " + "; ".join(
              f"{what} kernel {ms[0]:.4f} ms plain {ms[1]:.4f} ms ({ms[0] / bound[0]:.2f}x the "
              f"bound), combos bit-equal, db max_abs {e['max_abs_err']:.3e} ({w:.2e} of the "
              f"sum of magnitudes, limit {TOL_DB:.0e})" for what, (ms, e, w) in rows.items()),
          flush=True)
    return {"name": "qconv_dw_prep", "route": "cuda", "source": "qasr_torch/csrc/qconv_dw_prep.cu",
            "replaces": "qasr/ops/pallas/qconv_ft.py:490 (_ft_dw_impl's operands, left to XLA)",
            "launches": None, "max_abs_err": max(e["max_abs_err"] for _, e, _ in rows.values()),
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": None}


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
    from qasr_torch.ops.kernels.qconv_chain import qconv_dw
    from qasr_torch.ops.kernels.qconv_dx import conj_transpose_w, qconv_dx8, qconv_dx_plain
    from qasr_torch.ops.kernels.qconv_ft import qconv_ft8, qconv_stacked_plain
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
    if _build.build_log:  # this run built the library: ptxas's report of the wgmma loops
        print("phase 2 registers: " + "; ".join(_wg_registers(_build.build_log)), flush=True)

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
                ref = qconv_stacked_plain(x.float(), w, bb, aa)
                err = _errors(got, ref)
                _report(f"qconv_ft8 {shape} {dname} prologue+bias={bb is not None}", err, tol)
                if dtype == torch.bfloat16:  # and against the bf16 plain version
                    _report(f"qconv_ft8 {shape} bf16 prologue+bias={bb is not None} vs bf16 "
                            "plain", _errors(got, qconv_stacked_plain(x, w, bb, aa)), tol)
                if (t, dtype, bb is not None) == (256, torch.bfloat16, True):
                    results["qconv_ft8"] = err["max_abs_err"]
            for epi in (False, True):
                zz, sl = (x, slopes) if epi else (None, None)
                got, got_da = qconv_dx8(dz, w, zz, sl)
                ref, ref_da = qconv_dx_plain(dz.float(), w, None if zz is None else zz.float(), sl)
                err = _errors(got, ref)
                _report(f"qconv_dx8 {shape} {dname} epilogue={epi} dx", err, tol)
                if dtype == torch.bfloat16:
                    _report(f"qconv_dx8 {shape} bf16 epilogue={epi} dx vs bf16 plain",
                            _errors(got, qconv_dx_plain(dz, w, zz, sl)[0]), tol)
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
    for m, k, n in PHASE3_GEMMS:
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

    # the rank-8 input combos bit for bit (gated)
    mism = _combo_mismatches(dev)
    if any(mism.values()):
        raise RuntimeError(f"rank-8 combos differ from the JAX package's rounding: {mism}")
    print("phase 3 combos: kernels A, C and B in bf16 form every V8 combo bit for bit as the "
          "JAX package rounds it (B2 F5 T70 C72, M350 K72; one-hot weight combos, 8 products, "
          f"elements differing {mism})", flush=True)

    # no host-to-device copy in a warmed-up call of B or H, forward or dx:
    # such a copy from pageable memory synchronises the stream (gated; the
    # detector is first shown to see one)
    from qasr_torch.ops.kernels.qgemm import qgemm10, qgemm10_dx

    control = _h2d_copies(lambda: torch.as_tensor(np.ones(8, np.float32), device=dev))
    if not control:
        raise RuntimeError("the profiler recorded no host-to-device copy of a numpy array")
    xh, wh = rnd(4, 4096, 256, scale=0.5).to(torch.bfloat16), rnd(4, 256, 256, scale=0.06)
    for name, fn in (("qgemm8", qgemm8_cl), ("qgemm8_dx", qgemm8_dx), ("qgemm10", qgemm10),
                     ("qgemm10_dx", qgemm10_dx)):
        fn(xh, wh)  # warm-up
        copies = _h2d_copies(lambda: fn(xh, wh))
        if copies:
            raise RuntimeError(f"{name}: host-to-device copies in a warmed-up call: {copies}")
    print(f"phase 3 copies: no host-to-device copy in a warmed-up call of qgemm8, qgemm8_dx, "
          f"qgemm10, qgemm10_dx at M4096 K256 N256 bf16 (the profiler's control, a numpy "
          f"array to the card: {control})", flush=True)
    del xh, wh

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
    want = _want(qconv_ft8=2 * n_fat, qgemm8=2 * n_dense)  # two forwards
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
    tcfg = cfg.override(**TRAIN_OVERRIDES)
    batch = _train_batch(tcfg)
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
                                           lambda: qconv_stacked_plain(xa, wa, ba, aa), 10)
        xa_lib = xa.permute(0, 1, 4, 2, 3).reshape(16, 1024, 13, 256).contiguous()
        wa_lib = hamilton_expand(wa).permute(3, 2, 1, 0).contiguous().to(torch.bfloat16)
        lib = F.conv2d(xa_lib, wa_lib, padding=1)
        ref = qconv_stacked_plain(xa.float(), wa).permute(0, 1, 4, 2, 3)
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
                                           lambda: qconv_dx_plain(dza, wa, xa, sa), 10)
        dza_lib = dza.permute(0, 1, 4, 2, 3).reshape(16, 1024, 13, 256).contiguous()
        wc_lib = hamilton_expand(conj_transpose_w(wa)).permute(3, 2, 1, 0).contiguous()
        wc_lib = wc_lib.to(torch.bfloat16)
        lib = F.conv2d(dza_lib, wc_lib, padding=1)
        ref = qconv_dx_plain(dza.float(), wa)[0].permute(0, 1, 4, 2, 3)
        ref = ref.reshape(16, 1024, 13, 256)
        _gate("library conv2d for kernel C", _errors(lib, ref), TOL_BF16)
        lib_c = _time_ms(lambda: F.conv2d(dza_lib, wc_lib, padding=1), 10)
        # dz and z_prev in, dx out, the combos, slopes in and dalpha out
        bound_c = _bound(fl_a, 3 * _nbytes(dza) + 8 * 9 * 256 * 256 * 2 + 2 * _nbytes(sa))
        # kernel C without its epilogue (the first stacked layer's dx)
        c0_k, c0_p = _alternating(lambda: qconv_dx8(dza, wa), lambda: qconv_dx_plain(dza, wa), 10)
        # kernel K alone (gated against its plain version), then the layer's
        # dW and db whole: K, eight cuDNN weight-gradient convs, the U fold
        k_entry = phase5_kernel_k(xa, dza, sa, smi)
        dw_ms = _time_ms(lambda: qconv_dw(xa, dza, (3, 3)), 5)
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
          f"{c0_k:.3f} ms plain {c0_p:.3f} ms; qconv_dw (K + cuDNN wgrad) {dw_ms:.3f} ms; "
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
    want = _want(qconv_ft8=9, qconv_dx8=9, qgemm8=3, qgemm8_dx=3, qconv_dw_prep=9)
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
        lcfg, dev, "smoke_train", wavs, {"qconv_dx8": 9, "qgemm8_dx": 3, "qconv_dw_prep": 9})
    print(f"phase 6 train(): {lcfg.model.conv_features[0]}-wide qcnn, {lcfg.train.num_steps} "
          f"steps in {train_s:.2f} s, last log {json.dumps({k: last[k] for k in sorted(last)})}; "
          f"launches {train_counts}; checkpoint served {len(hyp)} utterances "
          f"(phones {[len(h) for h in hyp]})", flush=True)

    # 7. config 4 serving (its own launch counts)
    scan_entry = phase7_qlstm(dev, smi)
    # 8. config 4 training (its own launch counts)
    scan_bwd_entry = phase8_qlstm_train(dev, smi)
    # 9. timit_qcnn in the 10-product scheme, served and trained through the
    # CLI (its own launch counts)
    fast10_entries = phase9_fast10(dev, smi, tcfg, batch, wavs)
    # 10. kernel J through the probe, and the real-CNN baseline (config 3)
    # served and trained (their own launch counts)
    dgt_entry = phase10_dgt_real_cnn(dev, smi, tcfg, batch, wavs)
    # 11. the corpus path: mini-TIMIT and mini-LibriSpeech featurized on the
    # card, trained, resumed, evaluated and served (their own launch counts)
    phase11_corpus(dev, smi, tcfg, batch)
    # 12. the paper's decode protocol: fm32's kernel shapes, the TIMIT protocol
    # trained and beam-decoded on mini-TIMIT, and the device beam against the
    # host beam (their own launch counts)
    phase12_protocol(dev, smi)
    # 13. config 4's other arms (block, fast8, unidirectional, real_lstm)
    # served, trained and timed, and the rank-8 GEMM's f32 products (their
    # own launch counts)
    phase13_qlstm_arms(dev, smi)
    # 14. data, tensor and sequence parallelism: a world of one over NCCL
    # through the CLI, two ranks sharing the card over gloo (their own
    # launch counts, per rank)
    phase14_parallel(dev, smi)
    # 15. config 5 end to end with its tools (remat, the memory envelope, the
    # CLI on mini-LibriSpeech, TP 4 on the card, the scaling table) and the
    # packed XLA conv arms (their own launch counts)
    phase15_config5(dev, smi)

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
        {**k_entry, "launches": train_counts["qconv_dw_prep"]},
        scan_entry,
        scan_bwd_entry,
        *fast10_entries,
        dgt_entry,
    ])
    print(smi, flush=True)
    _line(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                           "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of qasr_torch on one CUDA card.")
    ap.add_argument("--time-kernels", metavar="TREE",
                    help="only time kernels A to J, the train steps and config 4's encoder "
                         "forward of the qasr_torch under TREE")
    ap.add_argument("--phase14-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--phase14-dir", help=argparse.SUPPRESS)
    ap.add_argument("--phase14-device", default="cuda:0", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.phase14_rank is not None:
        sys.exit(phase14_rank(args.phase14_rank, args.phase14_dir, args.phase14_device))
    sys.exit(main() if args.time_kernels is None else time_kernels(args.time_kernels))
