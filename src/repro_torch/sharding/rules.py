"""The block-parallel half of ``repro.sharding.rules``: blocks map to the
``pod`` axis of a ``(pod, data)`` mesh of ranks.

Blocks are gradient-isolated (paper §3), so the ``pod`` axis carries one
block per pod group with ZERO optimizer collectives across it; the only
cross-pod traffic is the periphery sync chosen by the trainer's policy.
JAX builds the mesh over its devices; the port builds it over the ranks of
the default process group (one process per device,
``repro_torch.parallel.dist``): rank ``b * data + d`` is pod ``b``, data
shard ``d``. What JAX's ``block_state_specs`` shards, the engine lays out
by hand: rank (b, d) holds block b's stacked slice and its AdamW state, a
replica of the periphery and its AdamW state, and rows ``d * n / data`` to
``(d + 1) * n / data`` of every batch.
"""
from __future__ import annotations

from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

BLOCK_AXIS = "pod"


def check_world(num_blocks: int, world: int) -> int:
    """The data size ``world // num_blocks``; raises unless every block
    gets a pod of the same number of ranks. JAX instead takes its first
    ``num_blocks * data`` devices (or falls back to round robin); under
    SPMD an idle extra process would hide a misconfigured launch."""
    if num_blocks < 1 or world < num_blocks or world % num_blocks:
        raise ValueError(
            f"block-parallel training over {world} processes needs a "
            f"multiple of the {num_blocks} blocks (one pod of equal size a "
            f"block); launch --nproc-per-node {num_blocks} or a multiple")
    return world // num_blocks


def block_parallel_mesh(num_blocks: int,
                        device_type: str = "cpu") -> Optional[DeviceMesh]:
    """(pod=num_blocks, data=W//num_blocks) mesh over the W ranks of the
    default process group, or ``None`` when this process is not part of one
    (the trainer is then the round-robin engine). ``device_type`` names the
    devices the ranks compute on."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    data = check_world(num_blocks, dist.get_world_size())
    return init_device_mesh(device_type, (num_blocks, data),
                            mesh_dim_names=(BLOCK_AXIS, "data"))

