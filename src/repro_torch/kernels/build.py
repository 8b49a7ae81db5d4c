"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Every ``csrc/*.cu`` compiles into its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so <name>.cu

The libraries land in ``build/repro_torch/<hash>/`` under the repository
root, where ``<hash>`` covers every source and header in ``csrc/`` and the
flags, so an edited kernel rebuilds and an unchanged one is reused.  All
sources compile in parallel at first use.  ``-Xptxas -v`` reports each
kernel's registers, shared memory and spills; the report is kept beside the
library (``ptxas_report``).

Each C entry returns ``cudaGetLastError()`` after its launch and the Python
wrapper raises on anything but 0 (``check``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def build_all() -> Dict[str, Path]:
    """Compile every missing library, all sources at once; → name → path."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {name: out_dir / f"lib{name}.so" for name in sources()}
    todo = {n: p for n, p in libs.items() if not p.exists()}
    if not todo:
        return libs
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        tmp = out_dir / f"lib{name}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(sources()[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, libs[name])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``lib<name>.so``, building it on first use."""
    with _lock:
        if name not in _libs:
            libs = build_all()
            if name not in libs:
                raise KeyError(f"no CUDA source csrc/{name}.cu")
            lib = ctypes.CDLL(str(libs[name]))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def parse_ptxas(log: str) -> List[str]:
    """One line per kernel of an ``nvcc -Xptxas -v`` log: its (mangled)
    name with ptxas's registers, shared memory, barriers and spill
    counts."""
    lines, entry, spill = [], "", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and entry:
            lines.append(f"{entry}: {line.split(':', 1)[1].strip()}; {spill}")
    return lines


def ptxas_report() -> Dict[str, List[str]]:
    """Per source, ``parse_ptxas`` of its build log."""
    out: Dict[str, List[str]] = {}
    for name in sources():
        log = build_dir() / f"{name}.log"
        if log.exists():
            out[name] = parse_ptxas(log.read_text())
    return out


_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream(device: torch.device) -> int:
    """The handle of the current CUDA stream on ``device``, for a launch.
    PyTorch's raw accessor where the build has it (a few µs cheaper than
    ``torch.cuda.current_stream(device).cuda_stream``, which it equals)."""
    if _raw_stream is None:
        return torch.cuda.current_stream(device).cuda_stream
    return _raw_stream(torch.cuda.current_device() if device.index is None
                       else device.index)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
