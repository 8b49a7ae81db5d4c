"""Design variants of the bf16 streaming-attention kernel, timed on the card
beside the shipped one: what the exponential, the split P·V, the LUT's
layout and the register cap each cost, and whether the precision checks
catch the lower-precision P·V that the design rejects.

Each variant is ``src/repro_torch/csrc`` with a few lines replaced
(``VARIANTS``; every replacement must match the shipped source exactly
once), built with the port's nvcc flags into
``build/repro_torch/variants/<hash>/<variant>/`` (all variants in parallel),
and driven through the port's own wrapper (``ops.streaming_attention``) at
kernel #3's main-path shapes (``chip_smoke.streaming_shapes``): the
BERT-large encodes and the deepseek-7b scoring batch, bf16.  The shipped
kernel is timed first and again last, and once with ``exp_mode="exact"``
(``expf`` in place of the LUT).  Times are ``chip_smoke.cuda_ms``: the median
of 20 CUDA-event timings with the L2 flushed before each.  Every variant
whose output means anything goes through ``chip_smoke``'s checks against
the plain version (one bf16 ulp beyond atol 3e-5, and ``PV_LIMITS`` against
the f32 plain version); a control that passes them is reported, not hidden.

Needs a CUDA card and nvcc:

    python3 tools/streaming_attention_variants.py [--out FILE]

It prints one line per reading and, last, one JSON object with them all
(also written to ``FILE``).  Not part of the port's main path.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402  (puts src/ on the path)

SA = "streaming_attention.cu"
LUT = "lut_exp.cuh"
MMA = "mma_ptx.cuh"

# The two mma that add p_lo·V.
_P_LO_MMA = [(SA, "        repro::mma_bf16(o[2 * n2], al, vf[0], vf[1]);\n", ""),
             (SA, "        repro::mma_bf16(o[2 * n2 + 1], al, vf[2], vf[3]);\n", "")]
_NO_EXP = [(SA, """  if constexpr (MODE == 2) return expf(x);
  else return repro::lut_exp_nonpos(x, tab, MODE == 0 ? 1 : 0);""",
            "  return x;")]

# name → (what it is, [(file, shipped text, replacement)], whether its
# output is the function's)
VARIANTS = {
    "no_exp": (
        "the exponential replaced by the identity: what the whole "
        "exponential costs (output meaningless)", _NO_EXP, False),
    "no_p_lo": (
        "P·V from p_hi alone (p truncated to bf16, one mma per fragment): "
        "what the split costs; a precision control", _P_LO_MMA, True),
    "p_rounded": (
        "p rounded once to bf16, one mma per fragment: the alternative the "
        "design rejects; a precision control",
        [(MMA, "  hi = __byte_perm(u0, u1, 0x7632);",
          "  hi = pack_bf16(__float2bfloat16_rn(x0), __float2bfloat16_rn(x1));"),
         *_P_LO_MMA], True),
    "no_exp_no_p_lo": (
        "both of the above: the products, loads, max and sums alone "
        "(output meaningless)", _NO_EXP + _P_LO_MMA, False),
    "table_32": (
        "the LUT replicated once per shared-memory bank (16 KB, entry d of "
        "lane l's copy at tab[32·d + l]: no bank conflict)",
        [(SA, "static constexpr int TAB_BYTES = repro::LUT_K * 4;",
          "static constexpr int TAB_BYTES = 32 * repro::LUT_K * 4;"),
         (SA, """  if constexpr (MODE != 2)
    for (int i = tid; i < repro::LUT_K; i += THREADS) tab[i] = p.table[i];""",
          """  if constexpr (MODE != 2)
    for (int i = tid; i < 32 * repro::LUT_K; i += THREADS) tab[i] = p.table[i / 32];"""),
         (LUT, "tab[__float_as_uint(db) - 0x4B000000u]",
          "tab[(__float_as_uint(db) - 0x4B000000u) * 32 + (threadIdx.x & 31)]")],
        True),
    "no_reg_cap": (
        "D <= 64 without the cap of 128 registers (no minimum of 4 blocks "
        "per SM)",
        [(SA, "static constexpr int MIN_BLOCKS = D <= 64 ? 4 : 1;",
          "static constexpr int MIN_BLOCKS = 1;")], True),
}


def variant_sources(name: str, csrc: Path) -> dict:
    """File name → text of ``csrc``'s sources with variant ``name``'s
    replacements; raises if one does not match exactly once."""
    files = {p.name: p.read_text() for p in sorted(csrc.iterdir())
             if p.suffix in (".cu", ".cuh")}
    for fname, old, new in VARIANTS[name][1]:
        n = files[fname].count(old)
        if n != 1:
            raise ValueError(f"variant {name}: {old!r} occurs {n} times in "
                             f"{fname}, expected once")
        files[fname] = files[fname].replace(old, new)
    return files


def build_variants(names) -> dict:
    """Build each variant's streaming-attention library, all at once;
    → name → (library path, ptxas lines)."""
    from repro_torch.kernels import build
    h = hashlib.sha256(build.source_hash().encode())
    h.update(json.dumps({n: VARIANTS[n][1] for n in names}).encode())
    root = build.BUILD_ROOT / "variants" / h.hexdigest()[:16]
    nvcc, procs = build.nvcc_path(), {}
    for name in names:
        d = root / name
        lib = d / "libstreaming_attention.so"
        if lib.exists():
            procs[name] = (lib, None)
            continue
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for fname, text in variant_sources(name, build.CSRC).items():
            (d / fname).write_text(text)
        cmd = [nvcc, *build.NVCC_FLAGS, "-I", str(d), "-o", str(lib),
               str(d / SA)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log_file = lib.parent / "nvcc.log"
        if proc is not None:
            log, _ = proc.communicate()
            log_file.write_text(log)
            if proc.returncode != 0:
                raise RuntimeError(f"variant {name}: nvcc failed\n{log}")
        out[name] = (lib, build.parse_ptxas(log_file.read_text()))
    return out


class use_library:
    """Within the block, the streaming-attention wrapper launches the
    kernels of the library at ``path`` (None: the shipped one)."""

    def __init__(self, path):
        self.path = path

    def __enter__(self):
        from repro_torch.kernels import build
        build.load("streaming_attention")
        self.saved = build._libs["streaming_attention"]
        if self.path is not None:
            lib = ctypes.CDLL(str(self.path))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            build._libs["streaming_attention"] = lib

    def __exit__(self, *exc):
        from repro_torch.kernels import build
        build._libs["streaming_attention"] = self.saved


def tc_registers(ptxas, d):
    """ptxas's line for the tensor-core kernel at head dim ``d``, LUT mode."""
    tag = f"tensor_core16attention_kernelILi{d}ELi0E"
    return next((line.split(": ", 1)[1] for line in ptxas if tag in line), "")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("streaming_attention_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.streaming_attention import (attention_ref,
                                                         streaming_attention)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    smoke.log(f"[card] {smi} | torch {torch.__version__}")
    t0 = time.perf_counter()
    build.build_all()
    built = build_variants(list(VARIANTS))
    smoke.log(f"[build] shipped + {len(built)} variants in "
              f"{time.perf_counter() - t0:.1f} s")
    shipped_ptxas = build.ptxas_report()["streaming_attention"]
    report = {"card": smi, "variants": {n: VARIANTS[n][0] for n in VARIANTS},
              "registers": {}, "ms": {}, "checks": {}}
    for name, (_, ptxas) in [("shipped", (None, shipped_ptxas)),
                             *built.items()]:
        report["registers"][name] = {d: tc_registers(ptxas, d)
                                     for d in (64, 128)}
        smoke.log(f"[ptxas] {name}: D 64 {report['registers'][name][64]} | "
                  f"D 128 {report['registers'][name][128]}")

    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=smoke.DEV)
    order = ["shipped", "exact_exp", *VARIANTS, "shipped_again"]
    for label, shape, causal in smoke.streaming_shapes():
        q, k, v = smoke.sa_inputs(shape, "bfloat16", seed=7)
        want32 = attention_ref(q.float(), k.float(), v.float(), causal=causal)
        row, checks = {}, {}
        for name in order:
            path = built[name][0] if name in built else None
            mode = "exact" if name == "exact_exp" else "lut"
            with use_library(path):
                call = lambda: streaming_attention(  # noqa: E731
                    q, k, v, causal=causal, exp_mode=mode)
                row[name] = smoke.cuda_ms(call, flush=flush_buf.zero_)
                meaningful = VARIANTS[name][2] if name in VARIANTS else True
                if meaningful and mode == "lut" and name != "shipped_again":
                    got = call()
                    ulps = smoke.bf16_ulps(got, want32.bfloat16(),
                                           smoke.SA_TOL["atol"])
                    pv = smoke.bf16_pv_precision(got, want32)
                    checks[name] = dict(
                        ulps=ulps, **pv,
                        passes=ulps <= 1.0 and smoke.pv_precision_ok(pv))
                    del got
        report["ms"][label], report["checks"][label] = row, checks
        base = row["shipped"]
        smoke.log(f"[time] {label}: " + ", ".join(
            f"{n} {t:.4f} ms ({(t / base - 1) * 100:+.1f}%)"
            for n, t in row.items()))
        for n, c in checks.items():
            smoke.log(f"[check] {label} {n}: {c['ulps']:.2f} bf16 ulp (limit "
                      f"1), rms {c['rms_ratio']:.4f}× the rounding's (limit "
                      f"{smoke.PV_LIMITS['rms_ratio']}), bias {c['bias']:.2e} "
                      f"(limit ±2^-12) → {'passes' if c['passes'] else 'FAILS'}")
        del q, k, v, want32
        torch.cuda.empty_cache()
    line = json.dumps(report)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
