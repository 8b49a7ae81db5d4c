"""Public int8 matmul entry point (port of
``src/repro/kernels/int8_matmul/ops.py``).

``int8_matmul(x, wq)`` quantises ``x`` dynamically (per-tensor absmax: the
``csrc/quantize.cu`` kernel through ``core.quant.quantize_dynamic``, where
the reference runs jnp outside its kernel), folds the leading dims into M
and runs the int8 tensor-core kernel (``csrc/int8_matmul.cu``) on the
current stream.  The reference's ``block_*`` and ``interpret`` arguments are
gone: the tiles are the kernel's compile-time choice, it masks ragged M and N
and zero-fills the K tail itself (the zero padding of the reference's
``_pad2``), and the tiling does not change the result — every output is the
exact int32 sum, then ``acc·(x_scale·w_scale[n])``, bit-equal to the plain
version (``ref.py``).

Two kernel variants, chosen from the host shape (``kernel_variant``):
``wgmma`` (TMA loads, ``wgmma`` s8 products) when K is a multiple of 16 and
both operands start 16-byte aligned — TMA's row stride and base alignment —
else ``mma_sync`` (``cp.async`` loads, ``mma.sync`` s8).  ``wgmma`` reads w
K-major, stride (1, K), as ``core.quant.quantize(w, axis=0)`` stores it; a
row-major w costs one transpose copy per call, counted in
``int8_matmul.transposes``.  ``mma_sync`` reads either layout in place.

CPU tensors take the plain version; CUDA tensors launch the kernel or raise.
``int8_matmul.launches`` counts kernel launches,
``int8_matmul.launches_by_variant`` splits them by variant.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.core.quant import QTensor, quantize_dynamic
from repro_torch.kernels import build
from repro_torch.kernels.int8_matmul.ref import (int8_matmul_2d_ref,
                                                 int8_matmul_ref)

MAX_M = 65535 * 128        # the grid's y extent × the kernel's 128-row tile
MAX_K = (2**31 - 1) // 2**14  # |acc| ≤ K·2^14 (operands of −128) fits int32
VARIANTS = ("wgmma", "mma_sync")
TILE_N = (128, 256)        # the wgmma variant's block widths

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("int8_matmul")
        fn = lib.int8_matmul_launch
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def k_major(wv: torch.Tensor) -> bool:
    """w (K, N) stored (N, K)-contiguous: stride (1, K) (a dim of size 1
    may keep any stride)."""
    (k, n), (sk, sn) = wv.shape, wv.stride()
    return (sk == 1 or k == 1) and (sn == k or n == 1)


def row_major(wv: torch.Tensor) -> bool:
    (k, n), (sk, sn) = wv.shape, wv.stride()
    return (sn == 1 or n == 1) and (sk == n or k == 1)


def kernel_variant(xv: torch.Tensor, wv: torch.Tensor) -> str:
    """The kernel a call launches: ``wgmma`` where TMA can describe both
    operands (K % 16 == 0, 16-byte aligned bases; a row-major w is copied
    K-major first, so its own base does not matter), else ``mma_sync``."""
    if xv.shape[1] % 16 or xv.data_ptr() % 16:
        return "mma_sync"
    return "mma_sync" if k_major(wv) and wv.data_ptr() % 16 else "wgmma"


def default_tile_n(m: int, n: int) -> int:
    """The wgmma variant's tile width: 256 columns (one tile per block,
    the faster at the BERT-large shapes on one H100, PERF.md), unless that
    grid would leave more than half of the card's 132 SMs idle; then 128
    (persistent blocks over twice the tiles)."""
    return 256 if math.ceil(m / 128) * math.ceil(n / 256) >= 66 else 128


def _check_w(wv, w_scale, dev):
    if wv.device != dev or w_scale.device != dev:
        raise ValueError(f"int8_matmul: w on {wv.device}, w_scale on "
                         f"{w_scale.device}, x on {dev}")
    if wv.dtype != torch.int8:
        raise TypeError(f"int8_matmul kernel: int8 values, got w {wv.dtype}")
    if w_scale.dtype != torch.float32:
        raise TypeError(f"int8_matmul kernel: float32 scales, got "
                        f"{w_scale.dtype}")
    if wv.dim() != 2:
        raise ValueError(f"int8_matmul kernel: w (K, N), got "
                         f"{tuple(wv.shape)}")
    k, n = wv.shape
    if tuple(w_scale.shape) != (1, n):
        raise ValueError(f"int8_matmul kernel: w_scale (1, {n}), got "
                         f"{tuple(w_scale.shape)}")
    if not (row_major(wv) or k_major(wv)) or not w_scale.is_contiguous():
        raise ValueError("int8_matmul kernel: w must be row-major or K-major "
                         "(stride (1, K)) and w_scale contiguous")
    if not 0 < k <= MAX_K or not 0 < n < 1 << 31:
        raise ValueError(f"int8_matmul kernel: unsupported w "
                         f"{tuple(wv.shape)} (0 < K ≤ {MAX_K}, 0 < N < 2^31)")


def _check(xv, wv, x_scale, w_scale):
    dev = xv.device
    _check_w(wv, w_scale, dev)
    if x_scale.device != dev:
        raise ValueError(f"int8_matmul: x_scale on {x_scale.device}, x on {dev}")
    if xv.dtype != torch.int8:
        raise TypeError(f"int8_matmul kernel: int8 values, got x {xv.dtype}, "
                        f"w {wv.dtype}")
    if x_scale.dtype != torch.float32:
        raise TypeError(f"int8_matmul kernel: float32 scales, got "
                        f"{x_scale.dtype}, {w_scale.dtype}")
    if xv.dim() != 2 or xv.shape[1] != wv.shape[0]:
        raise ValueError(f"int8_matmul kernel: x (M, K) and w (K, N), got "
                         f"{tuple(xv.shape)}, {tuple(wv.shape)}")
    if x_scale.numel() != 1:
        raise ValueError(f"int8_matmul kernel: x_scale of one value, got "
                         f"{tuple(x_scale.shape)}")
    if not xv.is_contiguous():
        raise ValueError("int8_matmul kernel: x must be contiguous")
    if xv.shape[0] > MAX_M:
        raise ValueError(f"int8_matmul kernel: unsupported shape x "
                         f"{tuple(xv.shape)} (M ≤ {MAX_M})")


def _launch(xv, wv, x_scale, w_scale, with_acc, variant=None, tile_n=None):
    m, k = xv.shape
    n = wv.shape[1]
    dev = xv.device
    lib = _library()
    variant = variant or kernel_variant(xv, wv)
    kmaj = k_major(wv)
    if variant == "wgmma" and not kmaj:
        wv = wv.t().contiguous().t()
        int8_matmul.transposes += 1
        kmaj = True
    # the two layouts' strides, whatever torch keeps for a dim of size 1
    sk, sn = (1, k) if kmaj else (n, 1)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    acc = torch.empty((m, n), dtype=torch.int32, device=dev) if with_acc else None
    err = lib.int8_matmul_launch(
        xv.data_ptr(), wv.data_ptr(), x_scale.data_ptr(), w_scale.data_ptr(),
        out.data_ptr(), None if acc is None else acc.data_ptr(), m, n, k,
        sk, sn, 0 if variant == "wgmma" else 1, tile_n or default_tile_n(m, n),
        build.stream(dev))
    if err:
        build.check(lib, err, f"int8_matmul launch ({variant})")
    int8_matmul.launches += 1
    int8_matmul.launches_by_variant[variant] += 1
    return (out, acc) if with_acc else out


def int8_matmul_2d(xv: torch.Tensor, wv: torch.Tensor, x_scale: torch.Tensor,
                   w_scale: torch.Tensor, *, with_acc: bool = False,
                   variant: Optional[str] = None,
                   tile_n: Optional[int] = None):
    """The kernel's own contract (the reference's ``int8_matmul_2d``): int8
    x (M, K) × int8 w (K, N) → f32 (M, N), scales applied; x_scale one f32,
    w_scale (1, N) f32; w row-major or K-major.  ``with_acc`` also returns
    the int32 accumulator, which the kernel then stores beside the output.
    ``variant`` and ``tile_n`` pin the kernel (``VARIANTS``) and the wgmma
    block width (``TILE_N``), for checks and timing; by default both follow
    the shape."""
    if xv.device.type == "cpu":
        return int8_matmul_2d_ref(xv, wv, x_scale, w_scale, with_acc=with_acc)
    if xv.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {xv.device}")
    build.refuse_grad("int8_matmul", x_scale, w_scale)
    _check(xv, wv, x_scale, w_scale)
    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"int8_matmul: variant in {VARIANTS}, got {variant!r}")
    if variant == "wgmma" and kernel_variant(xv, wv) != "wgmma":
        raise ValueError("int8_matmul: the wgmma variant needs K % 16 == 0 and "
                         "16-byte aligned operands")
    if tile_n is not None and tile_n not in TILE_N:
        raise ValueError(f"int8_matmul: tile_n in {TILE_N}, got {tile_n}")
    return _launch(xv, wv, x_scale, w_scale, with_acc, variant, tile_n)


def int8_matmul(x: torch.Tensor, wq: QTensor) -> torch.Tensor:
    """x (…, K) float × wq (K, N) int8 QTensor → (…, N) f32."""
    dev = x.device
    if dev.type == "cpu":
        return int8_matmul_ref(x, wq)
    if dev.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {dev}")
    build.refuse_grad("int8_matmul", x, wq[1])
    if not x.is_floating_point():
        raise TypeError(f"int8_matmul: x must be floating point, got {x.dtype}")
    wv, ws = wq
    _check_w(wv, ws, dev)
    *lead, k = x.shape
    if k != wv.shape[0]:
        raise ValueError(f"int8_matmul kernel: x (…, K) and w (K, N), got "
                         f"{tuple(x.shape)}, {tuple(wv.shape)}")
    m = math.prod(lead)
    if m > MAX_M:
        raise ValueError(f"int8_matmul kernel: unsupported shape x "
                         f"{tuple(x.shape)} (M ≤ {MAX_M})")
    xq = quantize_dynamic(x)
    return _launch(xq.values.view(m, k), wv, xq.scale, ws, False).view(
        *lead, wv.shape[1])


int8_matmul.launches = 0
int8_matmul.launches_by_variant = {v: 0 for v in VARIANTS}
int8_matmul.transposes = 0
