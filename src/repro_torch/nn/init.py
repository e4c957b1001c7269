"""Parameter specs and initialisation (port of ``repro.nn.init``).

Every layer declares a *spec tree*: a nested dict whose leaves are
``ParamSpec(shape, axes, init, scale)``. ``init_params`` walks it in sorted
key order (the order JAX flattens dicts in) and draws each leaf from one
``torch.Generator``. The param tree is a nested dict of tensors with the JAX
tree's keys; stacked layers keep their leading ``layers`` axis.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator, Optional, Tuple

import numpy as np
import torch

Axes = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Axes                       # logical axis names; len == len(shape)
    init: str = "normal"             # normal | zeros | ones | embed
    scale: float = 1.0               # multiplier on the fan-in init std

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_items(tree: Any, path: Tuple[str, ...] = ()
               ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], path + (k,))
    else:
        yield path, tree


def tree_map(fn: Callable, tree: Any, path: Tuple[str, ...] = ()) -> Any:
    """Map ``fn(path, leaf)`` over a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _fan_in_std(shape: Tuple[int, ...]) -> float:
    # fan-in = product of all but the last dim (weights stored (in..., out)).
    fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else shape[0]
    return 1.0 / math.sqrt(max(fan_in, 1))


def init_params(spec_tree: Any, generator: torch.Generator,
                dtype: torch.dtype = torch.float32) -> Any:
    """Initialise a spec tree on ``generator.device``. Same init kinds as
    the JAX package (the draws differ: tests bridge JAX params instead)."""
    device = generator.device
    out = {}
    for path, spec in tree_items(spec_tree):
        if spec.init == "zeros":
            p = torch.zeros(spec.shape, dtype=dtype, device=device)
        elif spec.init == "ones":
            p = torch.ones(spec.shape, dtype=dtype, device=device)
        elif spec.init == "embed":
            p = torch.randn(spec.shape, generator=generator, dtype=dtype,
                            device=device) * spec.scale
        else:  # normal: fan-in scaled
            std = _fan_in_std(spec.shape) * spec.scale
            p = torch.randn(spec.shape, generator=generator, dtype=dtype,
                            device=device) * std
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = p

    def subtrees(spec, node):   # keep leafless subtrees (nonparam_ln's {})
        for k, v in spec.items():
            if isinstance(v, dict):
                subtrees(v, node.setdefault(k, {}))
    subtrees(spec_tree, out)
    return out


def stack_specs(spec_tree: Any, n: int,
                axis_name: Optional[str] = "layers") -> Any:
    """Prepend a leading stacking dim (the ``layers`` axis)."""
    return tree_map(lambda _, s: ParamSpec((n,) + s.shape,
                                           (axis_name,) + s.axes,
                                           s.init, s.scale), spec_tree)


def cast_floating(tree: Any, dtype: torch.dtype,
                  keep: Tuple[str, ...] = ()) -> Any:
    """Copy of a param tree with floating leaves in ``dtype``; leaves under
    any key in ``keep`` stay as they are (norm gains are read in fp32)."""
    def one(path, x):
        if any(k in keep for k in path) or not x.is_floating_point():
            return x
        return x.to(dtype)
    return tree_map(one, tree)
