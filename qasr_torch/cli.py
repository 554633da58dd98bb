"""The port's command line (counterpart of ``qasr/cli.py``): train a preset,
or transcribe audio files with a checkpoint that training wrote.

  python -m qasr_torch.cli --preset tiny_synthetic [--set train.num_steps=500]
  python -m qasr_torch.cli --preset timit_qcnn --set data.dataset=synthetic \\
      model.op_variant=fused model.dense_variant=pallas
  python -m qasr_torch.cli transcribe --ckpt /tmp/qasr_ckpt [--beam] [--fold] f1.wav ...

Both run on the GPU unless ``--device cpu`` asks for the CPU. Training reads
the ``synthetic`` dataset only: the TIMIT and LibriSpeech feature pipeline
is not ported yet (ROADMAP.md Queue 1 item 8), and neither are resuming a
run and evaluating a checkpoint alone (``--resume``, ``--eval-only``:
Queue 1 item 9).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys


def _parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs the kernels' plain versions)")
    return ap


def main(argv=None):
    """Train ``--preset`` with the ``--set`` overrides on ``--device``; the
    checkpoints go to ``train.checkpoint_dir``. Prints the last metrics
    line as JSON."""
    ap = _parser("Train a qasr_torch preset (python -m qasr_torch.cli).")
    ap.add_argument("--preset", default="tiny_synthetic")
    ap.add_argument(
        "--set",
        action="append",
        nargs="+",
        default=[],
        metavar="key.path=value",
        help="config override(s); repeatable, and one --set accepts several "
        "space-separated key.path=value pairs",
    )
    ap.add_argument("--resume", action="store_true", help="not ported yet")
    ap.add_argument("--eval-only", action="store_true", help="not ported yet")
    ap.add_argument("--list-presets", action="store_true")
    args = ap.parse_args(argv)

    from qasr_torch.configs import PRESETS, get_config

    if args.list_presets:
        for name, cfg in PRESETS.items():
            print(f"{name}: arch={cfg.model.arch} dataset={cfg.data.dataset}")
        return None
    for flag, on in (("--resume", args.resume), ("--eval-only", args.eval_only)):
        if on:
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP.md Queue 1 item 9: resume with the "
                "data_state sidecar and best-dev-PER selection)"
            )

    cfg = get_config(args.preset)
    overrides = {}
    for kv in (x for group in args.set for x in group):
        if "=" not in kv:
            raise SystemExit(f"--set expects key.path=value, got {kv!r}")
        k, v = kv.split("=", 1)
        overrides[k] = v
    if overrides:
        cfg = cfg.override(**overrides)
    if cfg.data.dataset != "synthetic":
        raise SystemExit(
            f"qasr_torch trains on data.dataset=synthetic only: the {cfg.data.dataset} "
            "feature pipeline is not ported yet (ROADMAP.md Queue 1 item 8); add "
            "--set data.dataset=synthetic"
        )

    from qasr_torch.train.loop import train

    state, last = train(cfg, device=args.device)
    print(json.dumps({"step": state.step, **last}), flush=True)
    return last


def resolve_checkpoint(path: str, step: int | None = None) -> str:
    """A directory ``Transcriber`` reads: ``path`` itself when it holds
    ``params.npz``, else its ``step_<n>`` subdirectory (``step``, or the
    latest that training wrote)."""
    if step is None and os.path.exists(os.path.join(path, "params.npz")):
        return path
    steps = sorted(
        int(m.group(1)) for d in (os.listdir(path) if os.path.isdir(path) else [])
        if (m := re.fullmatch(r"step_(\d+)", d))
    )
    if step is not None:
        if step not in steps:
            raise SystemExit(f"no step_{step} in {path!r} (have {steps})")
        return os.path.join(path, f"step_{step}")
    if not steps:
        raise SystemExit(f"no checkpoint in {path!r} (neither params.npz nor step_<n>/)")
    return os.path.join(path, f"step_{steps[-1]}")


def transcribe_main(argv=None):
    """Transcribe audio files (SPHERE/RIFF wav, FLAC) with a checkpoint:
    one ``path<TAB>transcription`` line each. Returns the transcriptions."""
    ap = _parser("Transcribe audio files with a qasr_torch checkpoint.")
    ap.add_argument("--ckpt", required=True,
                    help="a checkpoint directory (params.npz + config.json) or a training "
                    "directory (its latest step_<n>)")
    ap.add_argument("--step", type=int, default=None, help="pin a step_<n> of a training directory")
    ap.add_argument("--beam", action="store_true", help="prefix beam search")
    ap.add_argument("--fold", action="store_true", help="TIMIT 61->39 scoring fold")
    ap.add_argument("files", nargs="+", help="audio files (SPHERE/RIFF wav, FLAC)")
    args = ap.parse_args(argv)

    from qasr_torch.infer import Transcriber

    t = Transcriber(resolve_checkpoint(args.ckpt, args.step), beam=args.beam, device=args.device)
    outs = []
    for path in args.files:
        out = t.transcribe_file(path, fold=args.fold)
        outs.append(out)
        text = out if isinstance(out, str) else " ".join(out)
        print(f"{path}\t{text}", flush=True)
    return outs


if __name__ == "__main__":
    argv = sys.argv[1:]
    if argv[:1] == ["transcribe"]:
        transcribe_main(argv[1:])
    else:
        main(argv)
