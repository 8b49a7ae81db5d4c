"""INT8 quantisation substrate (port of ``src/repro/core/quant.py``; paper
§V: all HASTILY evaluations are INT8).

Symmetric quantisation: weights per output channel (absmax, static),
activations per tensor (absmax, dynamic — the crossbar's input DAC range).
``quantize`` and ``quantize_dynamic`` give the reference's int8 values and
scales bit for bit on f32 and bf16 inputs, as the reference computes them
under ``jax.jit`` (every reference path that quantises — the Pallas wrapper,
the model code — is compiled; op-by-op dispatch divides by ``qmax`` where
the compiled program multiplies by its reciprocal, one f32 ulp apart on a
few scales).  The input is widened to f32 before the division (torch would
keep a bf16 tensor divided by a 0-d f32 scale in bf16, where the reference
divides in f32), ``torch.round`` rounds half to even as ``jnp.round`` does,
and the clip comes before the cast.
Scales stay device tensors: nothing here synchronises the stream.

``quantize_dynamic`` on CUDA tensors launches ``csrc/quantize.cu`` (absmax
and quantise, bit-equal to the plain version below; counted in
``quantize_dynamic.launches``) or raises; CPU tensors take the plain
version.  ``quantize(w, axis=0)`` of a 2-D weight returns its int8 values
as a (K, N) view of an (N, K)-contiguous tensor, stride (1, K): the layout
the int8 kernel's ``wgmma`` variant reads (K-major for both operands), paid
once when the weight is quantised.  Values and scales are the same as in
any other layout.

``int8_matmul`` on CPU tensors is the reference core's function; on CUDA
tensors it launches the int8 tensor-core kernel
(``kernels/int8_matmul``, ``csrc/int8_matmul.cu``) or raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple, Union

import numpy as np
import torch

from repro_torch.device import dense


class QTensor(NamedTuple):
    """int8 values + f32 scale; ``scale`` broadcasts against ``values``."""
    values: torch.Tensor   # int8
    scale: torch.Tensor    # f32

    @property
    def shape(self) -> torch.Size:
        return self.values.shape

    def dequantize(self) -> torch.Tensor:
        return self.values.to(torch.float32) * self.scale


def _qmax(bits: int) -> Tuple[float, float]:
    """qmax and, as the compiled reference forms ``absmax / qmax`` (XLA
    turns the division by a constant into a product with its f32
    reciprocal), the f32 reciprocal of qmax."""
    qmax = 2.0 ** (bits - 1) - 1.0
    return qmax, float(np.float32(1.0) / np.float32(qmax))


def _quantize(x: torch.Tensor, absmax: torch.Tensor, bits: int) -> QTensor:
    qmax, inv_qmax = _qmax(bits)
    scale = torch.clamp_min(absmax, 1e-12) * inv_qmax
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -qmax - 1, qmax)
    return QTensor(q.to(torch.int8), scale)


def quantize(w: torch.Tensor, axis: Union[int, Tuple[int, ...]] = -1, *,
             bits: int = 8) -> QTensor:
    """Symmetric per-channel quantisation.  ``axis``: reduced (input) dims.
    A 2-D weight reduced over its rows (``axis`` 0 or −2: one scale per
    output column) keeps its values K-major, stride (1, K)."""
    absmax = torch.amax(torch.abs(w.to(torch.float32)), dim=axis, keepdim=True)
    q = _quantize(w, absmax, bits)
    if w.dim() == 2 and axis in (0, -2):
        q = QTensor(q.values.t().contiguous().t(), q.scale)
    return q


_DYNAMIC_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_QMAX = {b: _qmax(b) for b in range(2, 9)}


def quantize_dynamic(x: torch.Tensor, *, bits: int = 8) -> QTensor:
    """Per-tensor dynamic activation quantisation; the scale is 0-d."""
    dev = x.device
    if dev.type == "cpu":
        return _quantize(x, torch.amax(torch.abs(x.to(torch.float32))), bits)
    if dev.type != "cuda":
        raise ValueError(f"quantize_dynamic: unsupported device {dev}")
    code = _DYNAMIC_DTYPES.get(x.dtype)
    if code is None:
        raise TypeError(f"quantize_dynamic kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if bits not in _QMAX:
        raise ValueError(f"quantize_dynamic: bits in [2, 8], got {bits}")
    n = x.numel()
    if n == 0 or not x.is_contiguous():
        raise ValueError("quantize_dynamic kernel needs a contiguous, "
                         "non-empty input")
    lib, build = _quantize_library()
    qmax, inv_qmax = _QMAX[bits]
    q = torch.empty(x.shape, dtype=torch.int8, device=dev)
    buf = torch.empty(2, dtype=torch.float32, device=dev)  # scale, scratch
    ptr = buf.data_ptr()
    err = lib.quantize_dynamic_launch(x.data_ptr(), n, code, inv_qmax, qmax,
                                      q.data_ptr(), ptr, ptr + 4,
                                      build.stream(dev))
    if err:
        build.check(lib, err, "quantize_dynamic launch")
    quantize_dynamic.launches += 1
    return QTensor(q, buf[0])


quantize_dynamic.launches = 0
_quantize_lib = None


def _quantize_library():
    """The quantisation kernel's ctypes handle (built on first use) and the
    build module (imported here: ``repro_torch.kernels`` imports this
    module)."""
    global _quantize_lib
    if _quantize_lib is None:
        from repro_torch.kernels import build
        lib = build.load("quantize")
        fn = lib.quantize_dynamic_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_float, ctypes.c_float] + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
        _quantize_lib = lib, build
    return _quantize_lib


def int8_accumulate(xv: torch.Tensor, wv: torch.Tensor) -> torch.Tensor:
    """int8 (…, K) × int8 (K, N) → exact int32 (…, N).  Contracted in f64,
    which is exact on every device (|acc| ≤ K·2^14 < 2^53): torch has no
    int32 product on the card, and ``int8 @ int8`` wraps in int8."""
    return torch.matmul(xv.to(torch.float64), wv.to(torch.float64)).to(torch.int32)


def int8_matmul(x: torch.Tensor, wq: QTensor) -> torch.Tensor:
    """x (…, K) float × wq (K, N) int8 → (…, N) f32.

    Activations are quantised dynamically, the contraction accumulates in
    int32, then both scales apply.  On the CPU in the reference core's order,
    ``(acc·x_scale)·w_scale``; on the card the kernel applies
    ``acc·(x_scale·w_scale)``, the reference Pallas kernel's order, which
    lands within two f32 ulps of the core's (a third of the outputs differ
    in the last bits).
    """
    if x.device.type == "cuda":
        from repro_torch.kernels.int8_matmul import ops
        return ops.int8_matmul(x, wq)
    if x.device.type != "cpu":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    xq = quantize_dynamic(x)
    acc = int8_accumulate(xq.values, wq.values)
    return acc.to(torch.float32) * xq.scale * torch.squeeze(wq.scale, 0)


def dense_maybe_quant(x: torch.Tensor, w, *, use_int8: bool = False
                      ) -> torch.Tensor:
    """Single dispatch point: full-precision or int8 matmul."""
    if isinstance(w, QTensor):
        return int8_matmul(x, w)
    if use_int8:
        return int8_matmul(x, quantize(w, axis=0))
    dt = torch.promote_types(x.dtype, w.dtype)     # as the reference's einsum
    return dense(x.to(dt), w.to(dt))
