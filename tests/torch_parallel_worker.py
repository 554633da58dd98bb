"""One rank of a gloo world on the CPU for ``tests/test_torch_parallel_worlds.py``.

    python -m tests.torch_parallel_worker --init file:///tmp/x/rdzv --rank R \\
        --world N --dir /tmp/x

Joins the world, runs every case of its world size (:data:`CASES`) in order
on the inputs the test wrote into ``--dir`` (``inputs.npz``: the bridged
weights and batches), and writes each case's results from rank 0 as
``<case>.npz`` (and ``<case>.json``) into ``--dir``. Imports the port only:
the test process holds the results against the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

#: the small synthetic model every case trains: ``tests/test_torch_train.py``'s
#: (tiny_synthetic at conv (8, 16, 16), dense (16,), B4, f32)
OVERRIDES = {
    "model.conv_features": (8, 16, 16),
    "model.dense_features": (16,),
    "model.compute_dtype": "float32",
    "model.dropout_rate": 0.0,
    "data.batch_size": 4,
    "data.num_synthetic": 16,
    "train.num_steps": 4,
    "train.warmup_steps": 1,
    "train.learning_rate": 3e-3,
    "train.weight_decay": 1e-2,
    "train.grad_clip": 1.0,
}
#: the sequence-parallel conv cases per world size: (variant, kh, kw, cin, cout)
SEQ_CONVS = {2: [("block", 3, 3, 4, 8), ("fast8", 5, 5, 8, 8)],
             4: [("block", 5, 5, 4, 8), ("fast8", 3, 3, 8, 8)]}
#: the meshes of the train-step cases per world size: (n_data, n_model)
STEP_MESHES = {1: [(1, 1)], 2: [(2, 1)], 4: [(2, 2)]}


def tiny_config(**extra):
    from qasr_torch.configs import get_config

    return get_config("tiny_synthetic").override(**{**OVERRIDES, **extra})


def seq_conv_inputs(n: int, variant: str, kh: int, kw: int, cin: int, cout: int):
    """x [2, 8n, 5, 4cin], w [4, kh, kw, cin, cout] and the output's
    cotangent, f32, from a seed."""
    rng = np.random.default_rng(100 * n + kh)
    x = rng.standard_normal((2, 8 * n, 5, 4 * cin)).astype(np.float32)
    w = (rng.standard_normal((4, kh, kw, cin, cout)) * 0.2).astype(np.float32)
    g = rng.standard_normal((2, 8 * n, 5, 4 * cout)).astype(np.float32)
    return x, w, g


def seq_ctc_inputs(n: int):
    """Ragged CTC inputs as ``tests/test_sharding.py``'s: B4, T 8n, V 13, L 5."""
    rng = np.random.RandomState(n)
    t = 8 * n
    logits = rng.randn(4, t, 13).astype(np.float32)
    labels = rng.randint(1, 13, size=(4, 5)).astype(np.int32)
    logit_lengths = np.asarray([t, t - 3, t // 2, 5], np.int32)
    label_lengths = np.asarray([5, 3, 2, 1], np.int32)
    return logits, labels, logit_lengths, label_lengths


def _save(directory: str, case: str, arrays: dict, meta: dict | None = None) -> None:
    np.savez(os.path.join(directory, f"{case}.npz"), **arrays)
    if meta is not None:
        with open(os.path.join(directory, f"{case}.json"), "w") as f:
            json.dump(meta, f)


def _tree(inputs: dict, prefix: str) -> dict:
    """The tensors of ``inputs`` saved under ``<prefix>/<name>``."""
    import torch

    return {k.split("/", 1)[1]: torch.from_numpy(v) for k, v in inputs.items()
            if k.startswith(prefix + "/")}


def _params_np(model) -> dict:
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def case_steps(args, inputs, rank, n):
    """Two sharded train steps per mesh of this world size, from the bridged
    weights, on the saved batches; rank 0 saves the metrics and the whole
    params after each step. Dropout 0, and once (DP only) dropout 0.3."""
    import torch

    from qasr_torch.parallel import create_sharded_train_state, make_mesh, make_sharded_train_step
    from qasr_torch.train.metrics import state_bytes

    params = _tree(inputs, "params")
    batches = [{k.split("/")[1]: v for k, v in inputs.items() if k.startswith(f"batch{i}/")}
               for i in range(2)]
    for nd, nm in STEP_MESHES[n]:
        runs = [("", {})] + ([("_dropout", {"model.dropout_rate": 0.3})] if nm == 1 else [])
        mesh = make_mesh(nd, nm)
        for tag, extra in runs:
            cfg = tiny_config(**extra)
            state, _ = create_sharded_train_state(cfg, mesh, device="cpu", params=params)
            step = make_sharded_train_step(cfg, mesh)
            out = {}
            for i, batch in enumerate(batches):
                m = step(state, batch)
                out[f"loss{i}"] = m["loss"].numpy()
                out[f"grad_norm{i}"] = m["grad_norm"].numpy()
                for k, v in _params_np(state.model).items():
                    out[f"params{i}/{k}"] = v
            persistent, gathered = state_bytes(state, cpu=True)
            sizes = [persistent.get("cpu", 0), gathered.get("cpu", 0)]
            per_rank = torch.zeros(n, 2, dtype=torch.int64)
            per_rank[rank] = torch.tensor(sizes)
            torch.distributed.all_reduce(per_rank)
            if rank == 0:
                _save(args.dir, f"steps_{nd}x{nm}{tag}", out,
                      {"state_bytes": per_rank.tolist()})


def case_seq(args, inputs, rank, n):
    """The halo conv (both arms) and the chunked CTC, with gradients; the
    chunks gathered on rank 0."""
    import torch

    from qasr_torch.parallel import ctc_loss_seq_parallel, make_mesh, qconv2d_seq_parallel
    from qasr_torch.parallel.collectives import all_gather_cat

    mesh = make_mesh(n, 1)
    out = {}
    for variant, kh, kw, cin, cout in SEQ_CONVS[n]:
        x, w, g = seq_conv_inputs(n, variant, kh, kw, cin, cout)
        t = x.shape[1] // n
        rows = slice(rank * t, (rank + 1) * t)
        xl = torch.from_numpy(x[:, rows]).requires_grad_(True)
        wt = torch.from_numpy(w).requires_grad_(True)
        y = qconv2d_seq_parallel(xl, wt, mesh, variant=variant)
        (y * torch.from_numpy(g[:, rows])).sum().backward()
        group = mesh.group("data")
        key = f"{variant}_{kh}x{kw}"
        out[f"{key}/y"] = all_gather_cat(y.detach(), group, dim=1).numpy()
        out[f"{key}/dx"] = all_gather_cat(xl.grad, group, dim=1).numpy()
        dw = wt.grad.clone()
        torch.distributed.all_reduce(dw, group=group)  # each rank's part of dW
        out[f"{key}/dw"] = dw.numpy()
    logits, labels, ll, tl = seq_ctc_inputs(n)
    t = logits.shape[1] // n
    lg = torch.from_numpy(logits[:, rank * t:(rank + 1) * t]).requires_grad_(True)
    loss = ctc_loss_seq_parallel(lg, torch.from_numpy(labels), torch.from_numpy(ll),
                                 torch.from_numpy(tl), mesh)
    loss.sum().backward()
    out["ctc/loss"] = loss.detach().numpy()
    out["ctc/dlogits"] = all_gather_cat(lg.grad, mesh.group("data"), dim=1).numpy()
    if rank == 0:
        _save(args.dir, f"seq_{n}", out)


def case_beam(args, inputs, rank, n):
    """The sharded W=16 beam eval and the greedy eval over 13 examples in
    batches of 8 (an uneven last batch), DP over the whole world."""
    import torch

    from qasr_torch.data.synthetic import SyntheticDataset
    from qasr_torch.models import build_model
    from qasr_torch.parallel import make_mesh
    from qasr_torch.train.loop import evaluate

    cfg = tiny_config(**{"data.num_synthetic": 13, "data.batch_size": 8})
    params = _tree(inputs, "trained")
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params)
    ds = SyntheticDataset(vocab=cfg.model.vocab, n_mels=cfg.data.n_mels, num_examples=13, seed=0)
    mesh = make_mesh(n, 1)
    res = {"beam": evaluate(cfg, model, ds, beam=True, mesh=mesh),
           "greedy": evaluate(cfg, model, ds, mesh=mesh)}
    if rank == 0:
        _save(args.dir, f"beam_{n}", {}, res)


def case_checkpoint(args, inputs, rank, n):
    """``train()`` under TP (model axis = the world): 4 steps uninterrupted,
    and 4 steps stopped after step 2 (an exception from the step) then
    resumed, each writing checkpoints every 2 steps."""
    import qasr_torch.parallel as par
    from qasr_torch.train.loop import train

    cfg = tiny_config(**{"mesh.model_axis": n, "train.checkpoint_every": 2,
                         "train.eval_every": 100, "train.log_every": 1})
    whole = os.path.join(args.dir, "ckpt_whole")
    train(cfg, device="cpu", checkpoint_dir=whole)
    real = par.make_sharded_train_step

    class Stop(Exception):
        pass

    def stopping(*a, **k):
        step = real(*a, **k)
        calls = []

        def wrapped(state, batch, **kw):
            if len(calls) == 2:
                raise Stop
            calls.append(1)
            return step(state, batch, **kw)

        return wrapped

    cut = os.path.join(args.dir, "ckpt_cut")
    par.make_sharded_train_step = stopping
    try:
        train(cfg, device="cpu", checkpoint_dir=cut)
    except Stop:
        pass
    finally:
        par.make_sharded_train_step = real
    train(cfg, device="cpu", checkpoint_dir=cut, resume=True)


CASES = {1: [case_steps], 2: [case_steps, case_seq, case_beam, case_checkpoint],
         4: [case_steps, case_seq, case_beam]}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--init", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--dir", required=True)
    args = ap.parse_args()

    import torch

    torch.set_num_threads(1)
    from qasr_torch.parallel import initialize_multihost

    initialize_multihost(args.init, num_processes=args.world, process_id=args.rank,
                         device="cpu")
    inputs = dict(np.load(os.path.join(args.dir, "inputs.npz")))
    try:
        for case in CASES[args.world]:
            case(args, inputs, args.rank, args.world)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
