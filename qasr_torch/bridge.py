"""Weights across the two packages.

The port keeps the JAX parameter names and shapes exactly, so the bridge is
a name flattening, not a re-layout: the JAX tree ``{"qconv_3": {"kernel":
...}}`` is the state_dict entry ``"qconv_3.kernel"``. A JAX-side caller
exports a restored tree with ``jax.tree.map(np.asarray, params)``; the port
reads it, or a ``.npz`` written from it, without JAX. The other way,
:func:`params_to_jax` gives a port-trained state_dict as a JAX tree.

``QBatchNorm``'s running statistics (its ``mean`` and ``cov`` buffers) are
the JAX ``batch_stats`` collection: :func:`params_from_jax` takes a
variables dict ``{"params": ..., "batch_stats": ...}`` into one state_dict,
and :func:`params_to_jax` gives such a dict back when the state_dict holds
them.

``.npz`` files hold flat ``"qconv_3/kernel"`` keys in f32.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str, sep: str, out: dict) -> dict:
    for name, value in tree.items():
        key = f"{prefix}{sep}{name}" if prefix else str(name)
        if isinstance(value, Mapping):
            _flatten(value, key, sep, out)
        else:
            out[key] = value
    return out


# the leaves of the JAX batch_stats collection (QBatchNorm's running statistics)
BATCH_STATS = ("mean", "cov")


def params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """Nested JAX param tree of numpy arrays -> state_dict (f32 tensors).

    A variables dict with the ``"params"`` collection level, and a
    ``"batch_stats"`` collection beside it, is accepted as well: both land
    in the one state_dict, the statistics as their layers' buffers.
    """
    if "params" in tree and set(tree) <= {"params", "batch_stats"}:
        flat = {}
        for collection in tree.values():
            _flatten(collection, "", ".", flat)
    else:
        flat = _flatten(tree, "", ".", {})
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in flat.items()}


def params_to_jax(state_dict: Mapping) -> dict:
    """state_dict -> the nested JAX param tree of f32 numpy arrays
    (``{"qconv_3": {"kernel": ...}}``), which the JAX package's
    ``model.apply({"params": tree}, ...)`` takes as it is. A state_dict
    holding running statistics (:data:`BATCH_STATS` leaves) gives the
    variables dict ``{"params": tree, "batch_stats": stats}`` instead."""
    trees: dict = {"params": {}, "batch_stats": {}}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        node = trees["batch_stats" if leaf in BATCH_STATS else "params"]
        for name in path:
            node = node.setdefault(name, {})
        if torch.is_tensor(value):
            value = value.detach().to("cpu", torch.float32).numpy()
        node[leaf] = np.asarray(value, np.float32)
    return trees if trees["batch_stats"] else trees["params"]


def save_params_npz(params: Mapping, path: str) -> None:
    """Write a state_dict (or a nested tree) as an ``.npz`` with flat
    ``"layer/param"`` keys in f32."""
    flat = _flatten(params, "", ".", {})
    arrays = {}
    for k, v in flat.items():
        if torch.is_tensor(v):
            v = v.detach().to("cpu", torch.float32).numpy()
        arrays[k.replace(".", "/")] = np.asarray(v, np.float32)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_params_npz(path: str) -> dict[str, torch.Tensor]:
    """Read an ``.npz`` of flat ``"layer/param"`` keys -> state_dict."""
    with np.load(path, allow_pickle=False) as z:
        return {k.replace("/", "."): torch.from_numpy(z[k].astype(np.float32)) for k in z.files}
