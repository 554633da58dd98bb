"""Parameter and batch sharding rules for DP x TP training (counterpart of
``qasr/parallel/sharding.py``).

Quaternion weights are stacked ``[4, *kernel, Cin, Cout]``; tensor
parallelism splits the output channels (the last axis) over the "model"
axis, so every shard keeps all four Hamilton components of its channels.
As in the reference this is weight-sharded storage with gathered compute:
each rank keeps its Cout slice of every sharded kernel and of its two AdamW
moments, and gathers the whole kernels for the forward and backward
(``qasr_torch.parallel.train``). Batches split their leading dim over
"data".

A spec is a tuple, one entry a dim (``None`` or an axis name); ``()`` is
replicated. Leaves are named by their state_dict key, whose parts are the
JAX package's tree path (``qasr_torch.bridge``).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import torch

from qasr_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, world


def param_spec(path_names: tuple[str, ...], leaf) -> tuple:
    """The spec of one leaf by its path and rank, as the reference's:

    - (quaternion) kernels ``[..., Cin, Cout]`` -> Cout over "model"
    - biases / PReLU alphas ``[4*Cout]`` -> replicated (a packed split would
      cut Hamilton component blocks unevenly)
    - everything else -> replicated
    """
    ndim = getattr(leaf, "ndim", 0)
    if "kernel" in path_names and ndim >= 2:
        return (None,) * (ndim - 1) + (MODEL_AXIS,)
    return ()


def leaf_spec(mesh: Mesh, name: str, leaf) -> tuple:
    """:func:`param_spec` of the leaf named ``name`` (``"qconv_3.kernel"``),
    replicated where the model axis does not divide its last dim (no uneven
    shards)."""
    spec = param_spec(tuple(name.split(".")), leaf)
    if spec and leaf.shape[-1] % mesh.shape[MODEL_AXIS]:
        return ()
    return spec


def _named_leaves(tree) -> Mapping:
    if hasattr(tree, "model"):  # a train state: its parameters
        tree = tree.model
    if isinstance(tree, torch.nn.Module):
        return dict(tree.named_parameters())
    return tree


def tree_shardings(mesh: Mesh, tree) -> Any:
    """Specs mirroring ``tree``: a state_dict (flat ``"a.b"`` keys), a
    nested mapping of leaves, a module or a train state (its parameters;
    AdamW's moments follow their parameter)."""
    tree = _named_leaves(tree)

    def walk(node, prefix):
        out = {}
        for k, v in node.items():
            name = f"{prefix}.{k}" if prefix else str(k)
            out[k] = walk(v, name) if isinstance(v, Mapping) else leaf_spec(mesh, name, v)
        return out

    return walk(tree, "")


# aliases with intent-revealing names, as the reference's
param_shardings = tree_shardings
state_shardings = tree_shardings


def batch_shardings(mesh: Mesh, batch) -> dict:
    return {k: (DATA_AXIS,) for k in batch}


def shard_rows(mesh: Mesh | None, n_rows: int) -> slice:
    """This rank's contiguous rows of a batch of ``n_rows`` split over "data"
    on ``mesh`` (ranks that share a data index share the rows), or over the
    world's ranks without one."""
    if mesh is None:
        i, n = world()
    else:
        i, n = mesh.index(DATA_AXIS), mesh.shape[DATA_AXIS]
    if n_rows % n:
        raise ValueError(f"global batch {n_rows} not divisible by the data axis {n}")
    local = n_rows // n
    return slice(i * local, (i + 1) * local)


def shard_batch(mesh: Mesh | None, batch: Mapping) -> dict:
    """This rank's rows (:func:`shard_rows`) of a batch that every process
    holds whole (numpy arrays or tensors; each leaf's leading dim is the
    batch)."""
    rows = shard_rows(mesh, len(next(iter(batch.values()))))
    return {k: v[rows] for k, v in batch.items()}


def shard_leaf(mesh: Mesh, spec: tuple, full: torch.Tensor) -> torch.Tensor:
    """This rank's slice of ``full`` under ``spec`` (a contiguous copy of
    its Cout slice, or ``full`` itself when replicated)."""
    if not spec:
        return full
    n = mesh.shape[MODEL_AXIS]
    c = full.shape[-1] // n
    j = mesh.index(MODEL_AXIS)
    return full[..., j * c:(j + 1) * c].contiguous()

