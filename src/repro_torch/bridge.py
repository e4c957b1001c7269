"""Parameter bridge between the JAX package's param tree and the port's.

The JAX tree is handed over as nested dicts of numpy arrays (bf16 leaves
either as ``astype(np.float32)`` or as ml_dtypes bfloat16, which is widened
here), so this module needs numpy only. Every leaf must map onto the port's
spec tree with an equal shape: a missing or extra key raises.
``params_to_numpy`` goes the other way: a port tree (params, AdamW moments)
as nested dicts of numpy arrays, which ``jax.tree_util.tree_map(jnp.asarray,
...)`` turns into the JAX package's tree.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.nn.init import ParamSpec


def _to_tensor(x, device) -> torch.Tensor:
    a = np.array(x)           # a writable copy (JAX hands out read-only views)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(a).to(device)


def params_from_jax(np_tree: Any, device, spec: Any,
                    _path: Tuple[str, ...] = ()) -> Any:
    """Convert ``np_tree`` (the JAX param tree as numpy) to the port's param
    tree on ``device``, checked leaf by leaf against ``spec`` (the port
    model's spec tree, e.g. ``model.spec``)."""
    where = "/".join(_path) or "<root>"
    if isinstance(spec, ParamSpec):
        if isinstance(np_tree, dict):
            raise KeyError(f"{where}: JAX tree has a subtree where the port "
                           "expects a leaf")
        shape = tuple(np.shape(np_tree))
        if shape != tuple(spec.shape):
            raise ValueError(f"{where}: JAX leaf shape {shape} != port spec "
                             f"shape {tuple(spec.shape)}")
        return _to_tensor(np_tree, device)
    if not isinstance(np_tree, dict):
        raise KeyError(f"{where}: JAX tree has a leaf where the port expects "
                       f"the subtree {sorted(spec)}")
    missing = sorted(set(spec) - set(np_tree))
    extra = sorted(set(np_tree) - set(spec))
    if missing or extra:
        raise KeyError(f"{where}: keys missing from the JAX tree {missing}, "
                       f"keys the port does not know {extra}")
    return {k: params_from_jax(np_tree[k], device, spec[k], _path + (k,))
            for k in spec}


def params_to_numpy(tree: Any) -> Any:
    """The port's tree as nested dicts of numpy arrays (bf16 widened to
    fp32), keys unchanged."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
