"""Design variants of #3's bf16 backward kernel at head dim 256, timed on
the card beside the shipped one: how the query step of the dK/dV pass and
the key step of the dQ pass trade registers and shared memory (so blocks
per SM) against fragments re-read, and where the shipped kernel's time
goes among its launches.

Each variant is ``src/repro_torch/csrc`` with a few lines replaced
(``VARIANTS``; every replacement must match the shipped source exactly
once), built with the port's nvcc flags into
``build/repro_torch/bwd_variants/<hash>/<variant>/`` (all in parallel),
and driven through the port's own wrapper (``ops.streaming_attention_bwd``)
at the head-dim-256 shapes of ``chip_smoke.BWD_SHAPES`` (gemma2-9b's and
gemma3-12b's training batches), bf16, fed the forward kernel's out and lse.
The shipped kernel is timed first and again last.  Times are
``chip_smoke.cuda_ms``: the median of 20 CUDA-event timings with the L2
flushed before each, as a caller sees them and on the device alone (a spin
ahead).  Every variant is held to the plain backward within
``chip_smoke.BWD_TOL`` and to itself over two calls (bit-equal).  The
shipped kernel's device time by launch (δ, the dK/dV kernels, dQ) comes
from a profiler trace of 10 calls.

Needs a CUDA card and nvcc:

    python3 tools/streaming_attention_bwd_variants.py [--out FILE]

It prints one line per reading and, last, one JSON object with them all
(also written to ``FILE``).  Not part of the port's main path.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402  (puts src/ on the path)

BWD = "streaming_attention_bwd.cu"
_BQ = (BWD, "static constexpr int BQ = D <= 64 ? 64 : 32;",
       "static constexpr int BQ = D <= 64 ? 64 : D <= 128 ? 32 : 16;")
_KT = (BWD, "static constexpr int KT = D <= 128 ? 64 : 16;",
       "static constexpr int KT = D <= 128 ? 64 : 32;")

# name → (what it is, [(file, shipped text, replacement)])
VARIANTS = {
    "bq16": ("D 256: the dK/dV pass steps 16 query rows (shipped: 32): "
             "fewer logit registers and ~99 KB of shared memory for a dK "
             "block (two blocks an SM), K and V fragments re-read per 16 "
             "rows", [_BQ]),
    "kt32": ("D 256: the dQ pass steps 32 keys (shipped: 16), as the "
             "forward does: ~129 KB of shared memory (one block an SM), Q "
             "and dO fragments re-read per 32 keys", [_KT]),
    "bq16_kt32": ("both of the above", [_BQ, _KT]),
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
    """Build each variant's backward library, all at once; → name →
    (library path, ptxas lines)."""
    from repro_torch.kernels import build
    h = hashlib.sha256(build.source_hash().encode())
    h.update(json.dumps({n: VARIANTS[n][1] for n in names}).encode())
    root = build.BUILD_ROOT / "bwd_variants" / h.hexdigest()[:16]
    nvcc, procs = build.nvcc_path(), {}
    for name in names:
        d = root / name
        lib = d / "libstreaming_attention_bwd.so"
        if lib.exists():
            procs[name] = (lib, None)
            continue
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for fname, text in variant_sources(name, build.CSRC).items():
            (d / fname).write_text(text)
        cmd = [nvcc, *build.NVCC_FLAGS, "-I", str(d), "-o", str(lib),
               str(d / BWD)]
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
    """Within the block, the backward wrapper launches the kernels of the
    library at ``path`` (None: the shipped one)."""

    def __init__(self, path):
        self.path = path

    def __enter__(self):
        from repro_torch.kernels import build
        build.load("streaming_attention_bwd")
        self.saved = build._libs["streaming_attention_bwd"]
        if self.path is not None:
            lib = ctypes.CDLL(str(self.path))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            build._libs["streaming_attention_bwd"] = lib

    def __exit__(self, *exc):
        from repro_torch.kernels import build
        build._libs["streaming_attention_bwd"] = self.saved


def d256_lines(ptxas):
    """ptxas's lines of the bf16 backward's head-dim-256 kernels, by
    kernel (``dkdv<256, part>``, ``dq<256>``)."""
    out = {}
    for line in ptxas:
        m = re.search(r"tensor_core\d+(dkdv_kernel|dq_kernel)ILi256E(?:Li(\d)E)?",
                      line)
        if m:
            name = m.group(1) + (f"<256, {m.group(2)}>" if m.group(2) else
                                 "<256>")
            out[name] = line.split(": ", 1)[1]
    return out


def by_launch(fn, calls=10):
    """Device ms of each kernel of ``fn`` (one backward call) from a
    profiler trace of ``calls`` calls, summed by kernel name, per call."""
    import torch
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        dev = getattr(e, "device_time_total", None) or getattr(
            e, "cuda_time_total", 0)
        name = e.key
        if dev and ("kernel" in name or "Kernel" in name):
            m = re.search(r"(delta_kernel|dkdv_kernel<256, \d>|"
                          r"dkdv_kernel<\d+, \d>|dq_kernel<\d+>)", name)
            out[m.group(1) if m else name[:60]] = dev / 1e3 / calls
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("streaming_attention_bwd_variants: no CUDA device",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.streaming_attention.ops import (
        attention_bwd_ref, streaming_attention_bwd)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    smoke.log(f"[card] {smi} | torch {torch.__version__}")
    t0 = time.perf_counter()
    build.build_all()
    built = build_variants(list(VARIANTS))
    smoke.log(f"[build] shipped + {len(built)} variants in "
              f"{time.perf_counter() - t0:.1f} s")
    report = {"card": smi, "variants": {n: VARIANTS[n][0] for n in VARIANTS},
              "ptxas": {}, "ms": {}, "device_ms": {}, "checks": {},
              "by_launch": {}}
    shipped_ptxas = build.ptxas_report()["streaming_attention_bwd"]
    for name, (_, ptxas) in [("shipped", (None, shipped_ptxas)),
                             *built.items()]:
        report["ptxas"][name] = d256_lines(ptxas)
        for k, line in report["ptxas"][name].items():
            smoke.log(f"[ptxas] {name} {k}: {line}")

    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=smoke.DEV)
    order = ["shipped", *VARIANTS, "shipped_again"]
    for label, shape, kw in smoke.BWD_SHAPES:
        if shape[-1] != 256:
            continue
        q, k, v, o, lse, dout = smoke.bwd_inputs(shape, "bfloat16", kw,
                                                 seed=37)
        scale = shape[-1] ** -0.5
        want = attention_bwd_ref(q, k, v, o, lse, dout, scale=scale, **kw)
        call = lambda: streaming_attention_bwd(  # noqa: E731
            q, k, v, o, lse, dout, scale=scale, **kw)
        row, dev_row, checks = {}, {}, {}
        for name in order:
            path = built[name][0] if name in built else None
            with use_library(path):
                row[name] = smoke.cuda_ms(call, flush=flush_buf.zero_)
                dev_row[name] = smoke.cuda_ms(call, flush=flush_buf.zero_,
                                              spin=True)
                if name == "shipped":
                    report["by_launch"][label] = by_launch(call)
                if name != "shipped_again":
                    got, again = call(), call()
                    rel = max(float((a.float() - w.float()).abs().max())
                              / float(w.float().abs().max())
                              for a, w in zip(got, want))
                    det = all(torch.equal(a, b) for a, b in zip(got, again))
                    checks[name] = dict(
                        rel_err=rel, deterministic=det,
                        passes=det and rel <= smoke.BWD_TOL["bfloat16"])
                    del got, again
        report["ms"][label], report["device_ms"][label] = row, dev_row
        report["checks"][label] = checks
        base = row["shipped"]
        smoke.log(f"[time] {label}: " + ", ".join(
            f"{n} {t:.4f} ms ({(t / base - 1) * 100:+.1f}%; device alone "
            f"{dev_row[n]:.4f})" for n, t in row.items()))
        smoke.log(f"[by launch] {label}, shipped: " + ", ".join(
            f"{n} {t:.4f} ms" for n, t in report["by_launch"][label].items()))
        for n, c in checks.items():
            smoke.log(f"[check] {label} {n}: max|Δ| / max|plain| "
                      f"{c['rel_err']:.3g} (limit 2^-7), two calls bit-equal "
                      f"{c['deterministic']} → "
                      f"{'passes' if c['passes'] else 'FAILS'}")
        del q, k, v, o, lse, dout, want
        torch.cuda.empty_cache()
    line = json.dumps(report)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
