"""Where a full-width training checkpoint's time goes, on one card: the
state of ``chip_smoke.py``'s phase 18 (deepseek-7b cut to 4 layers, bf16
moments: ~9.9 GB), saved and read back through ``repro_torch.checkpoint``.

    python3 tools/checkpoint_io.py [--out FILE]

Times (host clock, seconds): the trainer's ``init`` on the card; the host
copy of every leaf (``flatten_tree``); the npz write (``_savez``) and the
leaves' sha256 (``_shas``); the read of that npz by ``np.load`` and by the
store's own reader (``_load_npz``), in turns (``np.load``, reader, reader,
``np.load``); ``restore_flat`` whole (read and verify); the leaves' copy
to the card; ``Trainer.restore`` whole.  The files go to a temporary
directory under ``TMPDIR``, read back while the page cache still holds
them (warm reads).  Prints the card's name and power limit, then one JSON
object, also written to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("checkpoint_io: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.checkpoint import store
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.runtime import TrainConfig, Trainer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = get_config("deepseek-7b").replace(num_layers=4)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=512,
                      global_batch=8, corpus="lm")
    tmp = tempfile.mkdtemp(prefix="checkpoint_io_")
    tcfg = TrainConfig(steps=6, ckpt_every=10 ** 6, keep_ckpts=1,
                       moment_dtype="bfloat16", ckpt_dir=tmp)
    t = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        t[name] = time.perf_counter() - t0
        return out

    try:
        tr = Trainer(cfg, dcfg, tcfg, device="cuda")
        timed("init_s", tr.init)
        flat = timed("host_copy_s",
                     lambda: store.flatten_tree(tr._state_tree()))
        t["state_gb"] = sum(a.nbytes for a in flat.values()) / 1e9
        d = os.path.join(tmp, "probe")
        os.makedirs(d)
        npz = os.path.join(d, "arrays.npz")
        timed("savez_s", lambda: store._savez(npz, flat))
        timed("sha256_s", lambda: store._shas(flat))

        def np_load():
            with np.load(npz) as z:
                return {k: z[k] for k in z.files}

        def reader():
            return store._load_npz(npz)
        for i, (name, fn) in enumerate((("np_load", np_load),
                                        ("reader", reader),
                                        ("reader", reader),
                                        ("np_load", np_load))):
            timed(f"{name}_s_{i}", fn)
        shutil.rmtree(d)
        store.save(tmp, 2, flat, extra={"step": 2})
        del flat
        got = timed("restore_flat_s", lambda: store.restore_flat(tmp, 2)[0])
        timed("to_card_s", lambda: [v.to("cuda") for v in got.values()])
        del got, tr
        torch.cuda.empty_cache()
        tr = Trainer(cfg, dcfg, tcfg, device="cuda")
        timed("trainer_restore_s", tr.restore)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    facts = dict(card=card, **{k: round(v, 3) for k, v in t.items()})
    print(card)
    print(json.dumps(facts))
    if args.out:
        Path(args.out).write_text(json.dumps(facts, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
