"""The port's command line (counterpart of ``qasr/cli.py``): train a preset,
resume it, evaluate its best checkpoint, or transcribe audio files with a
checkpoint that training wrote.

  python -m qasr_torch.cli --preset tiny_synthetic [--set train.num_steps=500] [--resume]
  python -m qasr_torch.cli --preset timit_qcnn --set data.data_dir=/path/to/TIMIT
  python -m qasr_torch.cli --preset timit_qcnn --set data.data_dir=/path/to/TIMIT \\
      --eval-only [--beam] [--split core_test]
  python -m qasr_torch.cli transcribe --ckpt /tmp/qasr_ckpt [--beam] [--fold] f1.wav ...

Everything runs on the GPU unless ``--device cpu`` asks for the CPU.

Under ``torch.distributed.run`` the command trains on a world of ranks, one
process a card, on the mesh of ``cfg.mesh`` (data parallel over the rest of
the world, tensor parallel over ``mesh.model_axis``); only rank 0 prints and
writes:

  python -m torch.distributed.run --nproc-per-node 4 -m qasr_torch.cli \
      --preset librispeech_large --set mesh.model_axis=2

Rank r takes ``cuda:LOCAL_RANK`` and NCCL, one rank a card. When a node
starts more ranks than it has cards (NCCL refuses two ranks on one card),
rank r takes card ``LOCAL_RANK % cards`` and the world runs gloo on CUDA
tensors, so that config 5's ``mesh.model_axis=4`` runs on one card:

  python -m torch.distributed.run --nproc-per-node 4 -m qasr_torch.cli \
      --preset librispeech_large

``--device cpu`` runs gloo on the CPU.

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
                    "librispeech: dev-clean/test-clean; default: train, as the JAX "
                    "package's --eval-only)")
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
    device, rank = _join_world(args.device)
    try:
        if args.eval_only:
            return eval_only(cfg, split=args.split, beam=args.beam, device=device)

        from qasr_torch.train.loop import train

        state, last = train(cfg, device=device, resume=args.resume)
        if rank == 0:
            print(json.dumps({"step": state.step, **last}), flush=True)
        return last
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def _join_world(device: str) -> tuple[str, int]:
    """Under ``torch.distributed.run`` (its ``RANK`` and ``WORLD_SIZE`` in
    the environment) join the world; returns (device, rank). On the GPU,
    NCCL on ``cuda:LOCAL_RANK``, or, where the node's ranks
    (``LOCAL_WORLD_SIZE``) outnumber its cards, gloo on card ``LOCAL_RANK %
    cards``; on the CPU gloo. Elsewhere (device, 0)."""
    env = os.environ
    if not ("RANK" in env and "WORLD_SIZE" in env):
        return device, 0
    import torch

    from qasr_torch.parallel.mesh import initialize_multihost

    backend = None
    if torch.device(device).type == "cuda":
        local_rank, cards = int(env.get("LOCAL_RANK", 0)), torch.cuda.device_count()
        if int(env.get("LOCAL_WORLD_SIZE", 1)) > cards:
            local_rank, backend = local_rank % cards, "gloo"
        device = f"cuda:{local_rank}"
        torch.cuda.set_device(torch.device(device))
    rank, _ = initialize_multihost(device=device, backend=backend)
    return device, rank


def eval_only(cfg, *, split: str | None = None, beam: bool = False, device="cuda") -> dict:
    """Evaluate the checkpoint of ``cfg.train.checkpoint_dir`` that
    ``best.json`` names, or the latest when that step is gone, on ``split``
    (default the train split, ``build_dataset(cfg)``, as the JAX package's
    ``--eval-only`` does: ``qasr/cli.py:74``), decoded greedily or with the
    prefix beam (``beam``). Prints ``eval @ step N: {...} (split S)``;
    returns the metrics (``loss``, ``per``) with ``step``."""
    import torch.distributed as dist

    from qasr_torch.models import build_model
    from qasr_torch.train.checkpoint import CheckpointManager
    from qasr_torch.train.loop import build_dataset, build_mesh_from_config, evaluate

    ckpt = CheckpointManager(cfg, write_config=False)  # never overwrite the run's config
    best = ckpt.best_step()
    step = best if best is not None and best in ckpt.all_steps() else ckpt.latest_step()
    if step is None:
        raise SystemExit(f"no checkpoint in {cfg.train.checkpoint_dir}")
    split = split or "train"
    dataset = build_dataset(cfg, split=split, device=device)
    model = build_model(cfg, device=device)
    model.load_state_dict(ckpt.restore_params(step))
    mesh = build_mesh_from_config(cfg) if dist.is_initialized() else None
    dev = evaluate(cfg, model, dataset, beam=beam, mesh=mesh)
    if mesh is None or mesh.rank == 0:
        print(f"[qasr] eval @ step {step}: {dev} (split {split})", flush=True)
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
