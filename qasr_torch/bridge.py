"""Weights across the two packages.

The port keeps the JAX parameter names and shapes exactly, so the bridge is
a name flattening, not a re-layout: the JAX tree ``{"qconv_3": {"kernel":
...}}`` is the state_dict entry ``"qconv_3.kernel"``. A JAX-side caller
exports a restored tree with ``jax.tree.map(np.asarray, params)``; the port
reads it, or a ``.npz`` written from it, without JAX. The other way,
:func:`params_to_jax` gives a port-trained state_dict as a JAX tree.

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


def params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """Nested JAX param tree of numpy arrays -> state_dict (f32 tensors).

    A tree that still carries the ``{"params": ...}`` collection level is
    accepted as well.
    """
    if set(tree) == {"params"} and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    flat = _flatten(tree, "", ".", {})
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in flat.items()}


def params_to_jax(state_dict: Mapping) -> dict:
    """state_dict -> the nested JAX param tree of f32 numpy arrays
    (``{"qconv_3": {"kernel": ...}}``), which the JAX package's
    ``model.apply({"params": tree}, ...)`` takes as it is."""
    tree: dict = {}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        if torch.is_tensor(value):
            value = value.detach().to("cpu", torch.float32).numpy()
        node[leaf] = np.asarray(value, np.float32)
    return tree


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
