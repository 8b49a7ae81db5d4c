"""What ``chip_smoke.py``'s plain-attention step checks cost at full depth
and at the depth they run at (``step_check_cut``), on one card.

    python3 tools/step_check_cost.py [--out FILE]

For each model whose serving phase holds one ragged step through the
kernels against the plain attention (``phase_step_vs_plain``: deepseek-7b
in bf16 and f32, gemma2-9b, gemma3-12b, starcoder2-3b, granite-moe-3b-a800m)
the check runs twice on the same seeded weights and a pool of random
history rows, cut as ``chip_smoke.py`` cuts it and at the model's full
depth, in turns (cut, full, full, cut); prints each run's seconds (host
clock, the check's own device syncs included) and writes them as JSON to
``--out``.  Random history stands in for the served pool: the check's
cost depends on the step's shape, not on the rows' values.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

# (model, dtype, the floor its serving phase passes)
CHECKS = (("deepseek-7b", "bfloat16", 1e-2), ("deepseek-7b", "float32", 1e-3),
          ("gemma2-9b", "bfloat16", 1e-2), ("gemma3-12b", "bfloat16", 1e-2),
          ("starcoder2-3b", "bfloat16", 1e-2),
          ("granite-moe-3b-a800m", "bfloat16", 1e-2))


def timed_check(cfg, params, pool, label, floor, full):
    """One ``phase_step_vs_plain`` run → seconds; ``full`` lifts the cut."""
    import torch
    keep = cs.STEP_CHECK_LAYERS
    cs.STEP_CHECK_LAYERS = cfg.num_layers if full else keep
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = cs.phase_step_vs_plain(cfg, params, pool, label, floor=floor)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out["layers"]
    finally:
        cs.STEP_CHECK_LAYERS = keep


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("step_check_cost: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.device import configure_matmul_precision
    from repro_torch.models.lm import trunk_cache_init
    from repro_torch.params import init_params
    configure_matmul_precision()
    _, smi = cs.phase_card()
    out = {"card": smi, "checks": {}}
    for name, dtype, floor in CHECKS:
        cfg = get_config(name).replace(dtype=dtype)
        params = init_params(cfg, torch.Generator(device=cs.DEV).manual_seed(0),
                             cs.DEV)
        pool = trunk_cache_init(cfg, cs.ENGINE["num_pages"] + 1,
                                cs.ENGINE["page_size"], cs.DEV)
        g = torch.Generator(device=cs.DEV).manual_seed(3)
        for leaf in pool.values():
            leaf.normal_(generator=g)
        runs = {"cut": [], "full": []}
        layers = {}
        for full in (False, True, True, False):
            key = "full" if full else "cut"
            s, n = timed_check(cfg, params, pool, f"{name} {dtype} {key}",
                               floor, full)
            runs[key].append(s)
            layers[key] = n
        out["checks"][f"{name} {dtype}"] = dict(
            layers=layers, seconds=runs,
            saved_s=min(runs["full"]) - min(runs["cut"]))
        print(f"[step check cost] {name} {dtype}: {layers['cut']} layers "
              f"{['%.1f' % s for s in runs['cut']]} s, full depth "
              f"{layers['full']} layers {['%.1f' % s for s in runs['full']]} "
              f"s; {smi}", flush=True)
        del params, pool
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({k: round(v["saved_s"], 1)
                      for k, v in out["checks"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
