"""Block-parallel training state (port of ``repro.parallel.state``): every
block's unit slice, stacked.

Layout (``BlockParallelState``):

  stacks      {stack_key: tree}; each leaf is (B, u, ...) — block b's unit
              slice at index b along the leading axis (u = units per block).
              Blocks are contiguous and equal-sized, so each leaf is a VIEW
              (``Tensor.view``) of the (L, ...) master: no copy exists, an
              update of block b's slice lands in the masters, and
              ``BlockParallelTrainer.full_params`` is free.
  periph      the shared periphery (embeddings / readout / final norm /
              σ-conditioning): the masters' own leaves, ONE copy.
  stack_opt   ``AdamWState`` for the stacked views: ``step`` a (B,) int32
              host tensor (one AdamW step counter per block) and moments
              with the same leading (B, ...) block axis.
  periph_opt  ``AdamWState`` for the single periphery copy.

Under the pod-per-block mesh a rank's state holds its own block alone: the
stacks (1, u, ...) copies of its slice, ``step`` (1,), the moments (1, ...),
beside a replica of the periphery and its AdamW state (``engine.py``).

The stacked form requires equal block sizes; ``stack_block_views`` raises
``ValueError`` otherwise — use the sequential ``train_db`` path for
non-uniform partitions.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Tuple

from repro_torch.core.training import STACK_KEYS, write_back_block_view
from repro_torch.nn.init import tree_map


class BlockParallelState(NamedTuple):
    stacks: Any
    periph: Any
    stack_opt: Any
    periph_opt: Any


def split_periphery(params: dict) -> Tuple[dict, dict]:
    """(stacks, periphery) partition of a full params tree (the same
    tensors, no copies)."""
    stacks = {k: v for k, v in params.items() if k in STACK_KEYS}
    periph = {k: v for k, v in params.items() if k not in STACK_KEYS}
    return stacks, periph


def uniform_block_size(ranges: List[Tuple[int, int]]) -> int:
    sizes = {s for _, s in ranges}
    if len(sizes) != 1:
        raise ValueError(
            f"block-parallel training needs equal-sized blocks, got unit "
            f"ranges {ranges}; use sequential train_db or pass a uniform "
            f"``distribution``")
    return sizes.pop()


def stack_block_views(params: dict, ranges: List[Tuple[int, int]]) -> dict:
    """Every block's unit slice as (B, u, ...) views of the masters."""
    u = uniform_block_size(ranges)
    B = len(ranges)
    if [tuple(r) for r in ranges] != [(b * u, u) for b in range(B)]:
        raise ValueError(f"block-parallel training needs contiguous blocks "
                         f"from unit 0, got unit ranges {ranges}")
    stacks, _ = split_periphery(params)

    def one(path, x):
        if x.shape[0] != B * u:
            raise ValueError(f"{'/'.join(path)}: {x.shape[0]} units, the "
                             f"blocks cover {B * u}")
        return x.view(B, u, *x.shape[1:])
    return {k: tree_map(one, v, (k,)) for k, v in stacks.items()}


def block_view(stacks: dict, periph: dict, b: int) -> dict:
    """Block b's training view (what ``block_loss`` applies): its slice of
    every stack (views) and the periphery."""
    one = {k: tree_map(lambda _, x: x[b], v) for k, v in stacks.items()}
    return {**periph, **one}


def merge_params(params_template: dict, stacks: dict, periph: dict,
                 ranges: List[Tuple[int, int]]) -> dict:
    """Write every block's stacked slice + the shared periphery into
    ``params_template`` IN PLACE (inverse of ``stack_block_views``; leaves
    that already share the template's storage are skipped). Returns the
    template."""
    for b, (start, _) in enumerate(ranges):
        write_back_block_view(params_template, block_view(stacks, periph, b),
                              start)
    return params_template
