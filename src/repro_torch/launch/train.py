"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[...]`` (port of ``src/repro/launch/train.py``).

The reference's flags, plus ``--device`` (the card by default, ``cpu``
for the plain path; no card and no ``--device cpu`` raises).

``--distributed`` joins the gloo process group that ``torchrun`` describes
in the environment (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``), the port's stand-in for the reference's
``jax.distributed.initialize()``; ``--mesh`` trains on
``make_host_mesh()`` over the ranks that are running (one rank without
``--distributed``).  On one card::

    torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch deepseek-7b-smoke --distributed --mesh

trains in 2 ranks, each on its half of the global batch.
"""
from __future__ import annotations

import argparse
import os

import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.data import DataConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.runtime import TrainConfig, Trainer

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def init_distributed() -> None:
    """Join the gloo default group from ``torchrun``'s environment."""
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--distributed reads the process group from the environment "
            f"that torchrun sets ({', '.join(missing)} unset): start the "
            f"ranks with torchrun --nproc-per-node N -m "
            f"repro_torch.launch.train ... --distributed")
    dist.init_process_group("gloo", init_method="env://")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="config id; append -smoke for the reduced variant")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--corpus", default="lm", choices=["lm", "copy", "uniform"])
    ap.add_argument("--mesh", action="store_true",
                    help="shard over every running rank (make_host_mesh)")
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.distributed:
        init_distributed()
    try:
        train(args)
    finally:
        if args.distributed:
            dist.destroy_process_group()


def train(args) -> None:
    cfg = get_config(args.arch)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      global_batch=args.global_batch, corpus=args.corpus)
    tcfg = TrainConfig(steps=args.steps, lr=args.lr,
                       microbatches=args.microbatches,
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                       compress_grads=args.compress_grads)
    mesh = make_host_mesh() if args.mesh else None
    trainer = Trainer(cfg, dcfg, tcfg, mesh=mesh, device=args.device)
    metrics = trainer.run()
    if mesh is not None and mesh.rank != 0:
        return
    for m in metrics[:: max(len(metrics) // 20, 1)]:
        print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
              f"lr {m['lr']:.2e}  {m['ms']:.0f} ms")
    print(f"final loss: {metrics[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
