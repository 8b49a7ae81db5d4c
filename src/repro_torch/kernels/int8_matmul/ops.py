"""Public int8 matmul entry point (port of
``src/repro/kernels/int8_matmul/ops.py``).

``int8_matmul(x, wq)`` quantises ``x`` dynamically (per-tensor absmax, plain
torch, as the reference does it outside its kernel), folds the leading dims
into M and runs the int8 tensor-core kernel (``csrc/int8_matmul.cu``) on the
current stream.  The reference's ``block_*`` and ``interpret`` arguments are
gone: the tiles are the kernel's compile-time choice, it masks ragged M and N
and zero-fills the K tail itself (the zero padding of the reference's
``_pad2``), and the tiling does not change the result — every output is the
exact int32 sum, then ``acc·(x_scale·w_scale[n])``, bit-equal to the plain
version (``ref.py``).

CPU tensors take the plain version; CUDA tensors launch the kernel or raise.
``int8_matmul.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.quant import QTensor, quantize_dynamic
from repro_torch.kernels import build
from repro_torch.kernels.int8_matmul.ref import (int8_matmul_2d_ref,
                                                 int8_matmul_ref)

MAX_M = 65535 * 128        # the grid's y extent × the kernel's 128-row tile
MAX_K = (2**31 - 1) // 2**14  # |acc| ≤ K·2^14 (operands of −128) fits int32


def _library() -> ctypes.CDLL:
    lib = build.load("int8_matmul")
    fn = lib.int8_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(xv, wv, x_scale, w_scale):
    dev = xv.device
    for name, t in (("w", wv), ("x_scale", x_scale), ("w_scale", w_scale)):
        if t.device != dev:
            raise ValueError(f"int8_matmul: {name} on {t.device}, x on {dev}")
    if xv.dtype != torch.int8 or wv.dtype != torch.int8:
        raise TypeError(f"int8_matmul kernel: int8 values, got x {xv.dtype}, "
                        f"w {wv.dtype}")
    if x_scale.dtype != torch.float32 or w_scale.dtype != torch.float32:
        raise TypeError(f"int8_matmul kernel: float32 scales, got "
                        f"{x_scale.dtype}, {w_scale.dtype}")
    if xv.dim() != 2 or wv.dim() != 2 or xv.shape[1] != wv.shape[0]:
        raise ValueError(f"int8_matmul kernel: x (M, K) and w (K, N), got "
                         f"{tuple(xv.shape)}, {tuple(wv.shape)}")
    n = wv.shape[1]
    if x_scale.numel() != 1 or tuple(w_scale.shape) != (1, n):
        raise ValueError(f"int8_matmul kernel: x_scale of one value and "
                         f"w_scale (1, {n}), got {tuple(x_scale.shape)}, "
                         f"{tuple(w_scale.shape)}")
    if not all(t.is_contiguous() for t in (xv, wv, w_scale)):
        raise ValueError("int8_matmul kernel: x, w and w_scale must be "
                         "contiguous")
    k = wv.shape[0]
    if xv.shape[0] > MAX_M or not 0 < k <= MAX_K or not 0 < n < 1 << 31:
        raise ValueError(f"int8_matmul kernel: unsupported shape x "
                         f"{tuple(xv.shape)}, w {tuple(wv.shape)} (M ≤ "
                         f"{MAX_M}, 0 < K ≤ {MAX_K}, 0 < N < 2^31)")


def _launch(xv, wv, x_scale, w_scale, with_acc):
    m, k = xv.shape
    n = wv.shape[1]
    lib = _library()
    out = torch.empty((m, n), dtype=torch.float32, device=xv.device)
    acc = (torch.empty((m, n), dtype=torch.int32, device=xv.device)
           if with_acc else None)
    err = lib.int8_matmul_launch(
        xv.data_ptr(), wv.data_ptr(), x_scale.data_ptr(), w_scale.data_ptr(),
        out.data_ptr(), None if acc is None else acc.data_ptr(), m, n, k,
        torch.cuda.current_stream(xv.device).cuda_stream)
    build.check(lib, err, "int8_matmul launch")
    int8_matmul.launches += 1
    return (out, acc) if with_acc else out


def int8_matmul_2d(xv: torch.Tensor, wv: torch.Tensor, x_scale: torch.Tensor,
                   w_scale: torch.Tensor, *, with_acc: bool = False):
    """The kernel's own contract (the reference's ``int8_matmul_2d``): int8
    x (M, K) × int8 w (K, N) → f32 (M, N), scales applied; x_scale one f32,
    w_scale (1, N) f32.  ``with_acc`` also returns the int32 accumulator,
    which the kernel then stores beside the output."""
    if xv.device.type == "cpu":
        return int8_matmul_2d_ref(xv, wv, x_scale, w_scale, with_acc=with_acc)
    if xv.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {xv.device}")
    _check(xv, wv, x_scale, w_scale)
    return _launch(xv, wv, x_scale, w_scale, with_acc)


def int8_matmul(x: torch.Tensor, wq: QTensor) -> torch.Tensor:
    """x (…, K) float × wq (K, N) int8 QTensor → (…, N) f32."""
    if x.device.type == "cpu":
        return int8_matmul_ref(x, wq)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    if not x.is_floating_point():
        raise TypeError(f"int8_matmul: x must be floating point, got {x.dtype}")
    *lead, k = x.shape
    xq = quantize_dynamic(x)
    xv = xq.values.reshape(math.prod(lead), k)
    _check(xv, wq.values, xq.scale, wq.scale)
    return _launch(xv, wq.values, xq.scale, wq.scale, False).reshape(
        *lead, wq.values.shape[1])


int8_matmul.launches = 0
