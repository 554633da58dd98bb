"""The port's command line (counterpart of ``qasr/cli.py``): train a preset,
resume it, evaluate its best checkpoint, or transcribe audio files with a
checkpoint that training wrote.

  python -m qasr_torch.cli --preset tiny_synthetic [--set train.num_steps=500] [--resume]
  python -m qasr_torch.cli --preset timit_qcnn --set data.data_dir=/path/to/TIMIT
  python -m qasr_torch.cli --preset timit_qcnn --set data.data_dir=/path/to/TIMIT \\
      --eval-only [--beam] [--split core_test]
  python -m qasr_torch.cli transcribe --ckpt /tmp/qasr_ckpt [--beam] [--fold] f1.wav ...

Everything runs on the GPU unless ``--device cpu`` asks for the CPU.
``python -m qasr_torch.tools.make_mini_timit`` and ``make_mini_librispeech``
write small corpora in the two layouts.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs the kernels' plain versions)")
    return ap


def main(argv=None):
    """Train ``--preset`` with the ``--set`` overrides on ``--device`` (from
    the latest checkpoint with ``--resume``); the checkpoints go to
    ``train.checkpoint_dir``. Prints the last metrics line as JSON and
    returns it. With ``--eval-only``, evaluates a checkpoint instead and
    returns its metrics (see ``eval_only``)."""
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
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in train.checkpoint_dir")
    ap.add_argument("--eval-only", action="store_true",
                    help="evaluate the best (else the latest) checkpoint and exit")
    ap.add_argument("--beam", action="store_true",
                    help="--eval-only decodes with the prefix beam on the device "
                    "(decode.beam_width, decode.beam_prune_logp) instead of greedily")
    ap.add_argument("--split", default=None,
                    help="eval split for --eval-only (timit: dev/core_test/full_test; "
                    "librispeech: dev-clean/test-clean; default: the split train() "
                    "evaluates on)")
    ap.add_argument("--list-presets", action="store_true")
    args = ap.parse_args(argv)

    from qasr_torch.configs import PRESETS, get_config

    if args.list_presets:
        for name, cfg in PRESETS.items():
            print(f"{name}: arch={cfg.model.arch} dataset={cfg.data.dataset}")
        return None
    cfg = get_config(args.preset)
    overrides = {}
    for kv in (x for group in args.set for x in group):
        if "=" not in kv:
            raise SystemExit(f"--set expects key.path=value, got {kv!r}")
        k, v = kv.split("=", 1)
        overrides[k] = v
    if overrides:
        cfg = cfg.override(**overrides)
    if args.eval_only:
        return eval_only(cfg, split=args.split, beam=args.beam, device=args.device)

    from qasr_torch.train.loop import train

    state, last = train(cfg, device=args.device, resume=args.resume)
    print(json.dumps({"step": state.step, **last}), flush=True)
    return last


def eval_only(cfg, *, split: str | None = None, beam: bool = False, device="cuda") -> dict:
    """Evaluate the checkpoint of ``cfg.train.checkpoint_dir`` that
    ``best.json`` names, or the latest when that step is gone, on ``split``
    (default the set ``train()`` evaluates on: the dev split, or the train
    set for ``synthetic``), decoded greedily or with the prefix beam
    (``beam``). Prints ``eval @ step N: {...}``; returns the metrics
    (``loss``, ``per``) with ``step``."""
    from qasr_torch.models import build_model
    from qasr_torch.train.checkpoint import CheckpointManager
    from qasr_torch.train.loop import build_dataset, build_eval_dataset, evaluate

    ckpt = CheckpointManager(cfg, write_config=False)  # never overwrite the run's config
    best = ckpt.best_step()
    step = best if best is not None and best in ckpt.all_steps() else ckpt.latest_step()
    if step is None:
        raise SystemExit(f"no checkpoint in {cfg.train.checkpoint_dir}")
    if split is not None:
        dataset = build_dataset(cfg, split=split, device=device)
    else:
        dataset = build_eval_dataset(cfg, device=device)
    model = build_model(cfg, device=device)
    model.load_state_dict(ckpt.restore_params(step))
    dev = evaluate(cfg, model, dataset, beam=beam)
    print(f"[qasr] eval @ step {step}: {dev}", flush=True)
    return {"step": step, **dev}


def resolve_checkpoint(path: str, step: int | None = None) -> str:
    """A directory ``Transcriber`` reads: ``path`` itself when it holds
    ``params.npz``, else its ``step_<n>`` subdirectory: ``step``, or the one
    ``best.json`` names when it still exists, or the latest that training
    wrote."""
    from qasr_torch.train.checkpoint import best_step_in, steps_in

    if step is None and os.path.exists(os.path.join(path, "params.npz")):
        return path
    steps = steps_in(path)
    if step is not None:
        if step not in steps:
            raise SystemExit(f"no step_{step} in {path!r} (have {steps})")
        return os.path.join(path, f"step_{step}")
    if not steps:
        raise SystemExit(f"no checkpoint in {path!r} (neither params.npz nor step_<n>/)")
    best = best_step_in(path)
    return os.path.join(path, f"step_{best if best in steps else steps[-1]}")


def transcribe_main(argv=None):
    """Transcribe audio files (SPHERE/RIFF wav, FLAC) with a checkpoint:
    one ``path<TAB>transcription`` line each. Returns the transcriptions."""
    ap = _parser("Transcribe audio files with a qasr_torch checkpoint.")
    ap.add_argument("--ckpt", required=True,
                    help="a checkpoint directory (params.npz + config.json) or a training "
                    "directory (its best step_<n>, else its latest)")
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
