"""Train a DiffusionBlocks decoder with the PyTorch port (port of
``repro.launch.train``, single device, sequential):

  * ``--mode db`` (default): block-cycling DB training (paper Fig. 3); each
    step trains one uniformly drawn block, with its own AdamW state;
    gradients and moments exist for that block's units and the periphery
    only.
  * ``--mode e2e``: the end-to-end backprop baseline.

    PYTHONPATH=src python -m repro_torch.launch.train --steps 8   # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 2

Attention forward and backward go through the flash-attention kernels on
the card (their plain versions with ``--device cpu``). Data: ``MarkovLM``
batches, as the JAX CLI trains on.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import DBConfig, get_config, reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.core.blocks import DiffusionBlocksModel
from repro_torch.core.training import train_db, train_e2e
from repro_torch.data import MarkovLM


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
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the port trains on the card "
                         "(pass --device cpu to run its plain versions)")
    cfg = get_config(args.arch)
    cfg = cfg if args.full else reduced(cfg)
    db = DBConfig(num_blocks=min(args.blocks, cfg.n_layers),
                  overlap_gamma=0.1)
    dbm = DiffusionBlocksModel(cfg, db)
    tcfg = TrainConfig(steps=args.steps, batch_size=args.batch,
                       seq_len=args.seq, lr=args.lr, seed=args.seed,
                       log_every=max(1, min(10, args.steps // 4)))
    print(f"arch={cfg.name} layers={cfg.n_layers} blocks={db.num_blocks} "
          f"{dbm.ranges} mode={args.mode} precision={args.precision} "
          f"device={device}")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    data = MarkovLM(vocab_size=cfg.vocab_size, seed=7).iterator(args.batch,
                                                                args.seq)
    train = train_db if args.mode == "db" else train_e2e
    t0 = time.perf_counter()
    _, history = train(dbm, tcfg, data, gen, precision=args.precision)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"[{args.mode}] {args.steps} steps in {dt:.2f}s (on the card: "
          f"first-call kernel builds included); first loss "
          f"{history[0][2]:.4f}, last {history[-1][2]:.4f}")
    print("done")


if __name__ == "__main__":
    main()
