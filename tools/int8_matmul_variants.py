"""Diagnostic variants of the int8 matmul's wgmma kernel, timed on the card
beside the shipped one: where its time goes at the BERT-large projection
shapes — the loads alone, the products alone, the main loop without the
epilogue's stores — and whether a deeper or shallower ring moves it.

Each variant is ``src/repro_torch/csrc`` with a few lines replaced
(``VARIANTS``; every replacement must match the shipped source exactly
once), built with the port's nvcc flags into
``build/repro_torch/int8_variants/<hash>/<variant>/`` (all variants in
parallel), and driven through the port's own wrapper
(``ops.int8_matmul_2d``, wgmma variant, w K-major) at ``chip_smoke``'s
``INT8_TIMED`` shapes, at both tile widths.  Times are the device time
alone (``chip_smoke.cuda_ms`` with the spin lead: the median of 20
CUDA-event timings, L2 flushed before each); the shipped kernel is timed
first and again last.  Variants whose output is the function's are held
bit-equal to the plain version.

Needs a CUDA card and nvcc:

    python3 tools/int8_matmul_variants.py [--out FILE]

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

I8 = "int8_matmul.cu"

_NO_STORES = [(I8, "    for (int r = t / TPR; r < 64; r += RPP) {",
               "    for (int r = t / TPR; r < 0; r += RPP) {")]

# name → (what it is, [(file, shipped text, replacement)], whether its
# output is the function's)
VARIANTS = {
    "no_stores": (
        "the epilogue stages the accumulators but stores nothing: the main "
        "loop and the staging (output meaningless)", _NO_STORES, False),
    "loads_only": (
        "no products and no stores: the TMA ring alone, at the main loop's "
        "pace of releases (output meaningless)",
        [(I8, """        if constexpr (BN == 256) repro::wgmma_m64n256k32(acc, da, db, 1);
        else repro::wgmma_m64n128k32(acc, da, db, 1);""",
          """        (void)da;
        (void)db;"""), *_NO_STORES], False),
    "products_only": (
        "no loads (the producer arrives without bytes) and no stores: the "
        "wgmma issue alone on whatever shared memory holds (output "
        "meaningless)",
        [(I8, """          mbar_expect_tx(full + s, T::STAGE_BYTES);
          uint8_t* st = smem + s * T::STAGE_BYTES;
          tma_load(st, &xmap, kt * BK, m0, full + s);
          tma_load(st + T::A_BYTES, &wmap, kt * BK, n0, full + s);""",
          """          mbar_arrive(full + s);
          (void)m0;
          (void)n0;"""), *_NO_STORES], False),
    "stages_2": (
        "a ring of 2 stages in place of 4",
        [(I8, "  static constexpr int STAGES = 4;", "  static constexpr int STAGES = 2;")],
        True),
    "wait_0": (
        "each k-step's products drained before its stage is released "
        "(wgmma.wait_group 0: no k-step in flight across the release)",
        [(I8, """      repro::wgmma_wait<1>();                 // the previous k-step is done
      repro::wgmma_fence_operands<BN / 2>(acc);
      if (prev >= 0 && t == 0) mbar_arrive(empty + prev);""",
          """      repro::wgmma_wait<0>();
      repro::wgmma_fence_operands<BN / 2>(acc);
      if (t == 0) mbar_arrive(empty + s);
      prev = -1;
      if (++s == STAGES) { s = 0; ph ^= 1; }
      continue;"""),
         (I8, "    if (t == 0) mbar_arrive(empty + prev);    // the producer moves on",
          "    if (prev >= 0 && t == 0) mbar_arrive(empty + prev);")], True),
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
    """Build each variant's int8 matmul library, all at once; → name →
    (library path, ptxas lines)."""
    from repro_torch.kernels import build
    h = hashlib.sha256(build.source_hash().encode())
    h.update(json.dumps({n: VARIANTS[n][1] for n in names}).encode())
    root = build.BUILD_ROOT / "int8_variants" / h.hexdigest()[:16]
    nvcc, procs = build.nvcc_path(), {}
    for name in names:
        d = root / name
        lib = d / "libint8_matmul.so"
        if lib.exists():
            procs[name] = (lib, None)
            continue
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for fname, text in variant_sources(name, build.CSRC).items():
            (d / fname).write_text(text)
        cmd = [nvcc, *build.NVCC_FLAGS, "-I", str(d), "-o", str(lib), str(d / I8)]
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
    """Within the block, the int8 matmul wrapper launches the kernels of
    the library at ``path`` (None: the shipped one)."""

    def __init__(self, path):
        self.path = path

    def __enter__(self):
        from repro_torch.kernels.int8_matmul import ops
        self.saved = ops._library()
        if self.path is not None:
            lib = ctypes.CDLL(str(self.path))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            lib.int8_matmul_launch.argtypes = self.saved.int8_matmul_launch.argtypes
            lib.int8_matmul_launch.restype = ctypes.c_int
            ops._lib = lib

    def __exit__(self, *exc):
        from repro_torch.kernels.int8_matmul import ops
        ops._lib = self.saved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("int8_matmul_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.int8_matmul import int8_matmul_2d, int8_matmul_2d_ref
    from repro_torch.kernels.int8_matmul.ops import TILE_N
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
              "registers": {}, "device_ms": {}, "bit_equal": {}}
    for name, (_, ptxas) in [("shipped", (None, build.ptxas_report()["int8_matmul"])),
                             *built.items()]:
        report["registers"][name] = [line for line in ptxas if "wgmma_kernel" in line]

    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=smoke.DEV)
    g = torch.Generator(device=smoke.DEV).manual_seed(17)
    order = ["shipped", *VARIANTS, "shipped_again"]
    for m, k, n, what in smoke.INT8_TIMED:
        xv = torch.randint(-127, 128, (m, k), generator=g, device=smoke.DEV,
                           dtype=torch.int8)
        wv = torch.randint(-127, 128, (k, n), generator=g, device=smoke.DEV,
                           dtype=torch.int8).t().contiguous().t()
        xs = torch.rand((), generator=g, device=smoke.DEV) * 0.01
        ws = torch.rand((1, n), generator=g, device=smoke.DEV) * 0.01
        want = int8_matmul_2d_ref(xv, wv, xs, ws)
        label = f"{m}x{k}x{n}"
        for tile in TILE_N:
            row, equal = {}, {}
            for name in order:
                path = built[name][0] if name in built else None
                with use_library(path):
                    call = lambda: int8_matmul_2d(  # noqa: E731
                        xv, wv, xs, ws, variant="wgmma", tile_n=tile)
                    row[name] = smoke.cuda_ms(call, flush=flush_buf.zero_,
                                              spin=True)
                    if VARIANTS.get(name, (None, None, True))[2]:
                        equal[name] = smoke.bits_equal(call(), want)
            key = f"{label} tile {tile}"
            report["device_ms"][key], report["bit_equal"][key] = row, equal
            base = row["shipped"]
            smoke.log(f"[time] {key} ({what}): " + ", ".join(
                f"{nm} {ms:.4f} ms ({(ms / base - 1) * 100:+.1f}%)"
                for nm, ms in row.items()) + f"; bit-equal {equal}")
            if not all(equal.values()):
                smoke.fail(f"int8 variant not bit-equal at {key}: {equal}")
        del xv, wv, want
        torch.cuda.empty_cache()
    line = json.dumps(report)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
