"""Train a DiffusionBlocks decoder with the PyTorch port (port of
``repro.launch.train``, one device):

  * ``--mode db`` (default): block-cycling DB training (paper Fig. 3); each
    step trains one uniformly drawn block, with its own AdamW state;
    gradients and moments exist for that block's units and the periphery
    only.
  * ``--mode e2e``: the end-to-end backprop baseline.
  * ``--block-parallel``: every batch trains EVERY block
    (``repro_torch.parallel``), each block with its own AdamW moments, the
    shared periphery reconciled by ``--periphery``; per-block checkpoints in
    ``--ckpt-dir``. In one process the engine is round robin; under
    ``python -m torch.distributed.run`` with a multiple of the blocks'
    count of processes it is the pod-per-block mesh (``mode=shard_map``):
    one rank per mesh position, each on ``cuda:{LOCAL_RANK % cards}`` (or
    the CPU with ``--device cpu``), the process group on
    ``--dist-backend`` (default ``nccl`` on the card, ``gloo`` on the CPU;
    ranks that share a card need ``gloo``). Rank 0 prints and writes the
    shared files; an owner rank writes its block's.
  * ``--supervise`` (implied by ``--resume`` / ``--faults``): the
    ``TrainRunner`` fault-tolerant loop over ``--mode db`` or
    ``--block-parallel`` — generational crash-consistent checkpoints in
    ``--ckpt-dir``, per-block anomaly guards with rewind, heartbeats,
    pod-death degradation/re-adoption, bounded restart, and seeded fault
    injection.

    PYTHONPATH=src python -m repro_torch.launch.train --steps 8   # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 2
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --block-parallel --supervise --ckpt-dir /tmp/ck \
        --faults '{"grad_nan": {"at": [2]}}' --steps 8 [--resume]
    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 4 -m repro_torch.launch.train --device cpu \
        --dist-backend gloo --block-parallel --steps 8

Attention forward and backward go through the flash-attention kernels on
the card (their plain versions with ``--device cpu``). Data: ``MarkovLM``
batches, as the JAX CLI trains on.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.checkpoint import save_block
from repro_torch.configs import DBConfig, get_config, reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.core.blocks import DiffusionBlocksModel
from repro_torch.core.training import train_db, train_e2e
from repro_torch.data import HostDataLoader, MarkovLM, MarkovStream
from repro_torch.launch.faults import make_injector
from repro_torch.launch.trainrunner import TrainRunner
from repro_torch.models.model_api import build_model
from repro_torch.parallel import BlockParallelTrainer
from repro_torch.parallel import dist as D
from repro_torch.sharding import check_world


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--full", action="store_true",
                    help="train the published widths (default: reduced)")
    ap.add_argument("--mode", default="db", choices=["db", "e2e"])
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--precision", default="fp32", choices=["fp32", "bf16"],
                    help="fp32 masters + bf16 compute + fp32 reductions, or "
                         "pure fp32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--block-parallel", action="store_true")
    ap.add_argument("--dist-backend", default=None, choices=D.BACKENDS,
                    help="process-group backend under torch.distributed.run "
                         "(default: nccl on the card, gloo on the CPU; ranks "
                         "sharing one card need gloo)")
    ap.add_argument("--periphery", default="replicate+psum-mean",
                    help="periphery sync policy for --block-parallel "
                         "(replicate+psum-mean | owner-broadcast | "
                         "freeze-after-warmup)")
    ap.add_argument("--periphery-lr-scale", default=None,
                    help="--block-parallel: compensate the periphery's "
                         "1-update-per-batch cadence ('auto' = scale by the "
                         "block count, or a float; default off)")
    ap.add_argument("--ckpt-dir", default="")
    # -- fault-tolerant supervisor (repro_torch.launch.trainrunner) --------
    ap.add_argument("--supervise", action="store_true",
                    help="run under the TrainRunner supervisor: generational "
                         "crash-consistent checkpoints in --ckpt-dir, "
                         "per-block anomaly guards with rewind, heartbeats, "
                         "bounded restart (implied by --resume / --faults)")
    ap.add_argument("--ckpt-every", type=int, default=20,
                    help="supervisor checkpoint cadence (batches in "
                         "--block-parallel, steps in --mode db)")
    ap.add_argument("--ckpt-keep", type=int, default=3,
                    help="checkpoint generations to retain")
    ap.add_argument("--resume", action="store_true",
                    help="resume bit-identically from the latest good "
                         "generation in --ckpt-dir")
    ap.add_argument("--faults", default="",
                    help="JSON fault-injection spec, e.g. "
                         "'{\"pod_die\": {\"every\": 50}, "
                         "\"grad_nan\": {\"p\": 0.02}}' "
                         "(hooks: pod_die grad_nan data_stall ckpt_corrupt)")
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="restart budget for simulated process death "
                         "(--mode db pod_die)")
    ap.add_argument("--pod-restart-after", type=int, default=2,
                    help="batches a dead pod stays down before its block is "
                         "re-adopted (--block-parallel pod_die)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the port trains on the card "
                         "(pass --device cpu to run its plain versions)")
    cfg = get_config(args.arch)
    cfg = cfg if args.full else reduced(cfg)
    # at most one block a unit (an xLSTM unit is two layers), as JAX's CLI
    db = DBConfig(num_blocks=min(args.blocks, build_model(cfg).n_units),
                  overlap_gamma=0.1)
    if D.launched():
        if not args.block_parallel:
            raise SystemExit("under torch.distributed.run only "
                             "--block-parallel runs (one rank a pod)")
        try:
            check_world(db.num_blocks, D.env_ranks()[1])
        except ValueError as e:
            raise SystemExit(str(e)) from None
        device = D.pick_device(args.device)
        D.init(device, args.dist_backend)
        try:
            return _train(args, cfg, db, device,
                          print if D.env_ranks()[0] == 0 else _quiet)
        finally:
            torch.distributed.destroy_process_group()
    return _train(args, cfg, db, device, print)


def _quiet(*_a, **_k) -> None:
    """The log of a rank other than 0."""


def _engine_line(trainer: BlockParallelTrainer) -> str:
    """The engine's mode, and its mesh as JAX prints it."""
    line = f"block-parallel mode={trainer.mode}"
    if trainer.mesh is not None:
        shape = dict(zip(trainer.mesh.mesh_dim_names,
                         trainer.mesh.mesh.shape))
        line += f" mesh={shape}"
    return line


def _train(args, cfg, db, device, say):
    dbm = DiffusionBlocksModel(cfg, db)
    tcfg = TrainConfig(steps=args.steps, batch_size=args.batch,
                       seq_len=args.seq, lr=args.lr, seed=args.seed,
                       log_every=max(1, min(10, args.steps // 4)))
    supervise = args.supervise or args.resume or bool(args.faults)
    if supervise and args.mode == "e2e":
        raise SystemExit("--supervise covers --mode db and --block-parallel "
                         "only")
    mode = "block-parallel" if args.block_parallel else args.mode
    say(f"arch={cfg.name} layers={cfg.n_layers} blocks={db.num_blocks} "
        f"{dbm.ranges} mode={mode} precision={args.precision} "
        f"device={device} supervise={supervise}")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    lm = MarkovLM(vocab_size=cfg.vocab_size, seed=7)
    t0 = time.perf_counter()
    if supervise:
        runner = TrainRunner(
            dbm, tcfg, mode="block-parallel" if args.block_parallel else "db",
            periphery=args.periphery, precision=args.precision,
            periphery_lr_scale=args.periphery_lr_scale,
            ckpt_dir=args.ckpt_dir or None, ckpt_every=args.ckpt_every,
            keep=args.ckpt_keep,
            faults=make_injector(json.loads(args.faults) if args.faults
                                 else None, seed=args.fault_seed),
            max_restarts=args.max_restarts,
            pod_restart_after=args.pod_restart_after, log=say)

        def make_data(cur):
            src = (lm.stream(args.batch, args.seq) if cur is None
                   else MarkovStream.from_cursor(cur))
            return HostDataLoader(src, device=device)

        _, history = runner.train(make_data, gen, resume=args.resume)
        if args.block_parallel:
            say(_engine_line(runner.trainer))
        say("supervisor stats:", json.dumps(runner.stats()))
    else:
        data = lm.iterator(args.batch, args.seq)
        if args.block_parallel:
            trainer = BlockParallelTrainer(
                dbm, tcfg, periphery=args.periphery,
                precision=args.precision,
                periphery_lr_scale=args.periphery_lr_scale)
            say(_engine_line(trainer))
            _, history = trainer.train(data, gen, log=say,
                                       ckpt_dir=args.ckpt_dir or None)
        else:
            train = train_db if args.mode == "db" else train_e2e
            params, history = train(dbm, tcfg, data, gen,
                                    precision=args.precision)
            if args.ckpt_dir and args.mode == "db":
                for b, (start, size) in enumerate(dbm.ranges):
                    say("saved", save_block(args.ckpt_dir, params, b,
                                            start, size, step=args.steps))
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if history:
        say(f"[{mode}] {len(history)} steps in {dt:.2f}s (on the card: "
            f"first-call kernel builds included); first loss "
            f"{history[0][2]:.4f}, last {history[-1][2]:.4f}")
    say("done")


if __name__ == "__main__":
    main()
