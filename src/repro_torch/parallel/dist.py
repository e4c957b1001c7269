"""Process-group plumbing for the pod-per-block engine: the port's
counterpart of JAX's device mesh.

JAX drives every device of its ``(pod, data)`` mesh from one controller;
the port runs one process per mesh position (SPMD), launched by
``python -m torch.distributed.run``, which sets ``RANK``, ``WORLD_SIZE``
and ``LOCAL_RANK`` in each process's environment. This module reads them,
picks the process's device, creates the process group, and wraps the only
two collectives the engine uses, ``all_reduce`` (SUM) and ``broadcast``,
which are the only ones gloo takes on CUDA tensors.

Backends: ``nccl`` on the card (the default there), ``gloo`` on the CPU
(the default there) and on the card where several ranks share one device:
NCCL refuses two ranks on one device, and its error is left to surface as
it is; nothing switches backends behind the caller's back.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
# the default group ``init`` created and the device it set up for it
_INIT = {"group": None, "device": None}


def launched() -> bool:
    """True in a process started by ``torch.distributed.run``."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def env_ranks() -> Tuple[int, int, int]:
    """(rank, world size, local rank) as ``torch.distributed.run`` sets
    them."""
    return (int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
            int(os.environ.get("LOCAL_RANK", 0)))


def pick_device(device: str = "cuda") -> torch.device:
    """The CPU when ``device`` says so, else ``cuda:{LOCAL_RANK %
    device_count}``: ranks beyond the cards share them round robin."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the "
                           "ranks on the CPU")
    local = int(os.environ.get("LOCAL_RANK", 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def init(device: torch.device, backend: Optional[str] = None, *,
         init_method: str = "env://", rank: Optional[int] = None,
         world_size: Optional[int] = None,
         timeout_s: Optional[float] = None) -> str:
    """Create the default process group on ``backend`` (default: ``nccl``
    for a CUDA device, ``gloo`` for the CPU) and return the backend's name.
    ``rank``/``world_size`` default to the launcher's environment
    (``init_method="env://"``); tests pass them with a ``file://`` store."""
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    kw = {"backend": backend, "init_method": init_method}
    if rank is not None:
        kw.update(rank=rank, world_size=world_size)
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    if backend == "nccl":
        kw["device_id"] = device      # connect now: a refusal shows here
    dist.init_process_group(**kw)
    _INIT.update(group=dist.group.WORLD, device=device)
    return backend


def device_type() -> Optional[str]:
    """The type ("cuda" or "cpu") of the device ``init`` set this process
    up on; for a default group created elsewhere, its backend's (``nccl``:
    "cuda", else "cpu"); None with no process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    if _INIT["group"] is dist.group.WORLD:
        return _INIT["device"].type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _comm_device(t: torch.Tensor) -> torch.device:
    """Where the backend takes ``t``: NCCL only CUDA tensors (a host tensor
    goes through the current device), gloo both kinds."""
    if dist.get_backend() == "nccl" and t.device.type != "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


def _run(op, t: torch.Tensor) -> torch.Tensor:
    dev = _comm_device(t)
    if dev == t.device:
        op(t)
        return t
    staged = t.to(dev)
    op(staged)
    t.copy_(staged)
    return t


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over ``group`` (default: every rank) in place; every rank
    gets the same bits."""
    return _run(lambda x: dist.all_reduce(x, op=dist.ReduceOp.SUM,
                                          group=group), t)


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Overwrite ``t`` with rank ``src``'s (a global rank) in place."""
    return _run(lambda x: dist.broadcast(x, src=src, group=group), t)


def barrier() -> None:
    """Every rank waits for every other (an all-reduce of one zero)."""
    all_reduce(torch.zeros(1))


def check_same(values: torch.Tensor, what: str) -> None:
    """Raise on every rank unless ``values`` (an integer tensor) hold the
    same numbers on every rank."""
    flat = values.reshape(-1).to(torch.int64).cpu()
    rows = torch.zeros(dist.get_world_size(), flat.numel(),
                       dtype=torch.int64)
    rows[dist.get_rank()] = flat
    all_reduce(rows)
    differ = [r for r in range(rows.shape[0])
              if not torch.equal(rows[r], rows[0])]
    if differ:
        raise RuntimeError(f"{what} differs between ranks 0 and {differ}")
