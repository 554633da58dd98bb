"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port's serving path (``qasr_torch``, no JAX) once at the full
width of ``timit_qcnn`` (the paper's QCNN-256, bf16 compute, random weights
from a seeded ``torch.Generator``), through the two hand-written CUDA kernels,
and checks it. Phases, one line each:

  1. device   the card's name and power limit (nvidia-smi)
  2. build    nvcc build of qasr_torch/csrc/*.cu into qasr_torch/_build/
  3. parity   each kernel against its plain PyTorch version on the card, at
              the path's shapes, f32 (tight) and bf16 (loose), gated
  4. serving  a Transcriber on four synthetic 1-3 s waveforms, greedy and
              beam; kernel launch counts per forward; kernel-path logits
              against the plain path's, gated
  5. timing   encoder forward at B16 x T256 and each kernel at its path
              shape, kernel path against plain path (CUDA events; not gated)

then one JSON line with the per-kernel results and, last, the device line
``{"ok": true, "device": {...}}``. Any failure raises: the script then exits
non-zero and prints no result line. It fails without a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
# f32 runs the kernels' CUDA-core path: only the summation order differs
# from the plain version (cuDNN / cuBLAS in full f32, TF32 off).
TOL_F32 = {"rel_norm": 2e-5, "max_rel": 2e-4}
# bf16 rounds the input combos (V8 x) and the weight combos (U8 w) to an
# 8-bit mantissa (unit roundoff 2^-9 ~ 2e-3 each) before the f32-accumulated
# products: ~4e-3 relative per output, held against the f32 plain version
# on the same bf16 inputs.
TOL_BF16 = {"rel_norm": 1e-2, "max_rel": 5e-2}
# Serving logits in bf16 end to end, against the plain path in f32 on the
# same weights: each of the 13 layer boundaries rounds to bf16 (~4e-3 each,
# growing roughly as sqrt(13): ~1.4e-2). Kernel path against the bf16 plain
# path: two such paths rounding at different places, ~sqrt(2) more.
TOL_LOGITS_F32 = {"rel_norm": 3e-2, "max_rel": 1e-1}
TOL_LOGITS = {"rel_norm": 5e-2, "max_rel": 1e-1}


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


def _time_ms(fn, n: int) -> float:
    for _ in range(2):
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


def _alternating(kernel_fn, plain_fn, n: int) -> tuple[float, float]:
    """plain, kernel, kernel, plain; the mean of each pair."""
    p1 = _time_ms(plain_fn, n)
    k1 = _time_ms(kernel_fn, n)
    k2 = _time_ms(kernel_fn, n)
    p2 = _time_ms(plain_fn, n)
    return (k1 + k2) / 2, (p1 + p2) / 2


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    from qasr.configs import get_config
    from qasr_torch.infer import Transcriber, _next_time_pad
    from qasr_torch.models import build_model
    from qasr_torch.ops.kernels import _build
    from qasr_torch.ops.kernels.qconv_ft import qconv_fast8_stacked_plain, qconv_ft8
    from qasr_torch.ops.kernels.qgemm8 import qgemm8_cl, qgemm8_cl_plain

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
        x32 = rnd(b, 4, f, t, c, scale=0.5)
        for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
            x = x32.to(dtype)
            for bb, aa in ((None, None), (bias, alpha)):
                got = qconv_ft8(x, w, bb, aa)
                ref = qconv_fast8_stacked_plain(x.float(), w, bb, aa)
                torch.cuda.synchronize()
                err = _errors(got, ref)
                name = (f"qconv_ft8 B{b} F{f} T{t} C{c} k{ks[0]}x{ks[1]} "
                        f"{str(dtype)[6:]} prologue+bias={bb is not None}")
                _gate(name, err, tol)
                print(f"phase 3 parity {name}: max_abs {err['max_abs_err']:.3e} "
                      f"max_rel {err['max_rel']:.3e} rel_norm {err['rel_norm']:.3e} "
                      f"(tol {tol})", flush=True)
                if (t, dtype, bb is not None) == (256, torch.bfloat16, True):
                    results["qconv_ft8"] = err["max_abs_err"]
    for m, k, n in ((4096, 3328, 256), (1000, 3328, 256), (4096, 256, 256), (1000, 256, 256)):
        w = rnd(4, k, n, scale=(1.0 / k) ** 0.5)
        x32 = rnd(4, m, k, scale=0.5)
        for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
            x4 = x32.to(dtype)
            got = qgemm8_cl(x4, w)
            ref = qgemm8_cl_plain(x4.float(), w)
            torch.cuda.synchronize()
            err = _errors(got, ref)
            name = f"qgemm8 M{m} K{k} N{n} {str(dtype)[6:]}"
            _gate(name, err, tol)
            print(f"phase 3 parity {name}: max_abs {err['max_abs_err']:.3e} "
                  f"max_rel {err['max_rel']:.3e} rel_norm {err['rel_norm']:.3e} "
                  f"(tol {tol})", flush=True)
            if (m, k, dtype) == (4096, 3328, torch.bfloat16):
                results["qgemm8"] = err["max_abs_err"]

    # 4. serving: the port's main path, full width
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
    torch.cuda.synchronize()
    qconv_ft8.launches = 0
    qgemm8_cl.launches = 0
    hyp_greedy = greedy.transcribe_batch(wavs)
    hyp_beam = beam.transcribe_batch(wavs)
    torch.cuda.synchronize()
    launches = {"qconv_ft8": qconv_ft8.launches, "qgemm8": qgemm8_cl.launches}
    n_fat = sum(greedy.model.stacked)
    n_dense = greedy.model.n_dense
    want = {"qconv_ft8": 2 * n_fat, "qgemm8": 2 * n_dense}  # two forwards
    if launches != want or n_fat != 9 or n_dense != 3:
        raise RuntimeError(f"kernel launches {launches}, expected {want} (9 and 3 per forward)")
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
          f"qconv_ft8 {launches['qconv_ft8'] // 2} qgemm8 {launches['qgemm8'] // 2}; "
          f"greedy phones {[len(h) for h in hyp_greedy]}, beam (W={cfg.decode.beam_width}, "
          f"prune {cfg.decode.beam_prune_logp}) phones {[len(h) for h in hyp_beam]}; "
          f"logits kernel vs plain max_abs {lerr['max_abs_err']:.3e} "
          f"rel_norm {lerr['rel_norm']:.3e} (tol {TOL_LOGITS}); against the f32 plain "
          f"path: kernel rel_norm {kerr32['rel_norm']:.3e}, bf16 plain rel_norm "
          f"{perr32['rel_norm']:.3e} (tol {TOL_LOGITS_F32})", flush=True)

    # 5. timing (informational)
    enc = greedy.model
    feats = rnd(16, 256, cfg.data.n_mels, 4)
    audio_s = 16 * 256 * 0.010  # 10 ms hop per frame
    with torch.no_grad():
        fwd_k, fwd_p = _alternating(lambda: enc(feats), lambda: enc(feats, plain=True), 5)
        xa = rnd(16, 4, 13, 256, 256, scale=0.5).to(torch.bfloat16)
        wa = rnd(4, 3, 3, 256, 256, scale=0.02)
        ba, aa = rnd(1024, scale=0.1), rnd(1024, scale=0.25).abs()
        a_k, a_p = _alternating(lambda: qconv_ft8(xa, wa, ba, aa),
                                lambda: qconv_fast8_stacked_plain(xa, wa, ba, aa), 10)
        xb = rnd(4, 4096, 3328, scale=0.5).to(torch.bfloat16)
        wb = rnd(4, 3328, 256, scale=0.02)
        b_k, b_p = _alternating(lambda: qgemm8_cl(xb, wb), lambda: qgemm8_cl_plain(xb, wb), 10)
        xb2 = rnd(4, 4096, 256, scale=0.5).to(torch.bfloat16)
        wb2 = rnd(4, 256, 256, scale=0.05)
        b2_k, b2_p = _alternating(lambda: qgemm8_cl(xb2, wb2),
                                  lambda: qgemm8_cl_plain(xb2, wb2), 10)
    print(f"phase 5 timing on {smi}: encoder fwd B16xT256 kernel {fwd_k:.3f} ms "
          f"({audio_s / fwd_k * 1e3:.1f} audio-s/s), plain {fwd_p:.3f} ms "
          f"({audio_s / fwd_p * 1e3:.1f} audio-s/s); qconv_ft8 B16 F13 T256 C256 "
          f"kernel {a_k:.3f} ms plain {a_p:.3f} ms; qgemm8 M4096 K3328 N256 kernel "
          f"{b_k:.3f} ms plain {b_p:.3f} ms; qgemm8 M4096 K256 N256 kernel "
          f"{b2_k:.3f} ms plain {b2_p:.3f} ms; build {build_s:.2f} s", flush=True)

    _line(kernels=[
        {"name": "qconv_ft8", "route": "cuda", "source": "qasr_torch/csrc/qconv_ft8.cu",
         "replaces": "qasr/ops/pallas/qconv_ft.py:120", "launches": launches["qconv_ft8"],
         "max_abs_err": results["qconv_ft8"], "ms": a_k, "plain_ms": a_p},
        {"name": "qgemm8", "route": "cuda", "source": "qasr_torch/csrc/qgemm8.cu",
         "replaces": "qasr/ops/pallas/qgemm8.py:84", "launches": launches["qgemm8"],
         "max_abs_err": results["qgemm8"], "ms": b_k, "plain_ms": b_p},
    ])
    print(smi, flush=True)
    _line(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                           "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
