"""Tune kernel #2's block shapes on the card and write the port's table.

    python3 tools/tune_kernels.py [--table PATH] [--out FILE.json]

Runs ``chip_smoke.phase_tuner`` — ``tune(geom_for(deepseek-7b, page size
16), platform="cuda", measure=True)`` for the bf16 and the int8 pool over
phase 7's steps weighted by kind (``chip_smoke.phase7_steps``), every
candidate measured on the kernel and held against the plain version — then
writes the bf16 pool's winner, the engine's default pool, with its pages
per split named, with ``save_config`` as the ``deepseek-7b::cuda`` and
``default::cuda`` rows of the table (default: the port's committed
``src/repro_torch/kernels/autotune.json``; ``--table`` writes a copy of it
elsewhere and updates that).  ``--out`` keeps both pools' reports as JSON.
Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--table", default=None,
                    help="table to write (default: the committed one)")
    ap.add_argument("--out", default=None, help="reports as JSON")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("tune_kernels: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import autotune
    committed = autotune.table_path()
    table = Path(args.table) if args.table else committed
    if table != committed:
        table.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(committed, table)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    chip_smoke.CARD[0] = smi
    chip_smoke.log(f"[card] {smi}")
    from repro_torch.kernels.paged_attention.ops import default_kv_split
    reports = chip_smoke.phase_tuner(chip_smoke.phase7_steps())
    winner = autotune.KernelConfig(**reports["bf16"]["winner"])
    winner = dataclasses.replace(winner, kv_split=winner.kv_split or
                                 default_kv_split(chip_smoke.ENGINE[
                                     "page_size"]))
    for model in (chip_smoke.MODEL, "default"):
        autotune.save_config(model, "cuda", winner, path=table)
    chip_smoke.log(f"[tune_kernels] wrote {winner.describe()} as "
                   f"{chip_smoke.MODEL}::cuda and default::cuda to {table}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(card=smi, **reports),
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
