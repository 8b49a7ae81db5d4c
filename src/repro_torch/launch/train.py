"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[...]`` (port of ``src/repro/launch/train.py``).

The reference's flags, plus ``--device`` (the card by default, ``cpu``
for the plain path; no card and no ``--device cpu`` raises).  ``--mesh``
and ``--distributed`` raise: they come with the training half of the
tensor-parallel slice.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.data import DataConfig
from repro_torch.runtime import TrainConfig, Trainer

_LATER = ("comes with the training half of the tensor-parallel slice of "
          "the PyTorch port (ROADMAP.md §1 item 5)")


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
                    help="shard over all local devices")
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.distributed:
        raise NotImplementedError(f"--distributed {_LATER}")
    if args.mesh:
        raise NotImplementedError(f"--mesh {_LATER}")
    cfg = get_config(args.arch)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      global_batch=args.global_batch, corpus=args.corpus)
    tcfg = TrainConfig(steps=args.steps, lr=args.lr,
                       microbatches=args.microbatches,
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                       compress_grads=args.compress_grads)
    trainer = Trainer(cfg, dcfg, tcfg, device=args.device)
    metrics = trainer.run()
    for m in metrics[:: max(len(metrics) // 20, 1)]:
        print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
              f"lr {m['lr']:.2e}  {m['ms']:.0f} ms")
    print(f"final loss: {metrics[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
