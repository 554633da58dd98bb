"""The TIMIT acceptance protocol in one command (the port's counterpart of
``tools/run_timit_protocol.py``).

  1. train the preset (or resume its run, or skip training),
  2. select the best dev-PER checkpoint (``best.json``; the latest when that
     step is gone),
  3. decode dev and core-test with the reference decode protocol (prefix
     beam search, W = 100, -20 nat emission pruning, on the device),
  4. score the Lee-Hon 61->39 fold's PER,
  5. print ONE JSON line with the reference tool's keys.

Against a TIMIT directory, on the GPU:

  python -m qasr_torch.tools.run_timit_protocol --data-dir /path/to/TIMIT \\
      --ckpt /path/to/run

Against the mini-TIMIT fixture (``--make-mini`` writes it, 16 train speakers
of 10 utterances), the JAX package's recorded run:

  python -m qasr_torch.tools.run_timit_protocol --make-mini \\
      --preset timit_qcnn_fm32 --set train.num_steps=1500

``--device cpu`` runs it on the CPU (the kernels' plain versions). Progress
goes to stderr; stdout carries the JSON line alone.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile


def main(argv=None) -> dict:
    """Run the protocol; prints the acceptance line and returns it."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default="timit_qcnn",
                    help="timit_qcnn = the paper's best model (QCNN-256)")
    ap.add_argument("--data-dir", default=None, help="TIMIT root")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "qasr_timit_protocol"),
                    help="the run's checkpoint directory")
    ap.add_argument("--make-mini", action="store_true",
                    help="no corpus: write the mini-TIMIT fixture (into --data-dir when given)")
    ap.add_argument("--set", action="append", nargs="+", default=[],
                    metavar="key.path=value", help="config override(s), as the CLI's")
    ap.add_argument("--skip-train", action="store_true",
                    help="decode only, from the existing checkpoint")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs the kernels' plain "
                    "versions)")
    args = ap.parse_args(argv)

    data_dir = args.data_dir
    if args.make_mini:
        data_dir = data_dir or os.path.join(tempfile.gettempdir(), "qasr_mini_timit_protocol")
        if not os.path.isdir(os.path.join(data_dir, "train")):
            from qasr_torch.tools.make_mini_timit import write_corpus

            n = write_corpus(data_dir, train_speakers=16, utts_per_speaker=10)
            print(f"[protocol] wrote {data_dir}: {n}", file=sys.stderr)
    if not data_dir:
        raise SystemExit("need --data-dir (or --make-mini for the fixture)")

    from qasr_torch.configs import get_config

    overrides = {"data.data_dir": data_dir, "train.checkpoint_dir": args.ckpt}
    for kv in (x for group in args.set for x in group):
        if "=" not in kv:
            raise SystemExit(f"--set expects key.path=value, got {kv!r}")
        k, v = kv.split("=", 1)
        overrides[k] = v
    cfg = get_config(args.preset).override(**overrides)

    # 1. train or restore
    from qasr_torch.models import build_model
    from qasr_torch.train.checkpoint import CheckpointManager
    from qasr_torch.train.loop import build_dataset, evaluate, train

    latest = CheckpointManager(cfg, write_config=False).latest_step()
    trained_here = False
    if args.skip_train:
        if latest is None:
            raise SystemExit(f"--skip-train but no checkpoint in {args.ckpt}")
    elif latest is not None and latest >= cfg.train.num_steps:
        print(f"[protocol] checkpoint at step {latest} covers num_steps={cfg.train.num_steps}; "
              "skipping training", file=sys.stderr)
    else:
        print(f"[protocol] training {args.preset} -> {args.ckpt}", file=sys.stderr)
        with contextlib.redirect_stdout(sys.stderr):  # stdout: the JSON line alone
            train(cfg, device=args.device, resume=latest is not None)
        trained_here = True

    # 2. best-dev-PER model selection
    ckpt = CheckpointManager(cfg, write_config=False)
    best = ckpt.best_step()
    step = best if best is not None and best in ckpt.all_steps() else ckpt.latest_step()
    model = build_model(cfg, device=args.device)
    model.load_state_dict(ckpt.restore_params(step))

    # 3-4. the reference decode protocol on dev and core test
    results = {}
    for split in ("dev", "core_test"):
        print(f"[protocol] beam-decoding {split} (W={cfg.decode.beam_width}, "
              f"prune={cfg.decode.beam_prune_logp})", file=sys.stderr)
        ds = build_dataset(cfg, split=split, device=args.device)
        results[split] = evaluate(cfg, model, ds, beam=True)["per"]

    # 5. the acceptance line
    line = {
        "protocol": "timit_per",
        "preset": args.preset,
        "step": int(step),
        "selected_by": "best_dev_per" if best is not None else "latest",
        "beam_width": cfg.decode.beam_width,
        "beam_prune_logp": cfg.decode.beam_prune_logp,
        "fold": "lee_hon_61_to_39",
        "dev_per": round(float(results["dev"]), 4),
        "test_per": round(float(results["core_test"]), 4),
        "trained_here": trained_here,
        "data_dir": data_dir,
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
