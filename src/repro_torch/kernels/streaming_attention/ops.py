"""Public streaming-attention entry point (port of
``src/repro/kernels/streaming_attention/ops.py``).

Takes the model layout q ``(B, Hq, Lq, D)``, k/v ``(B, Hkv, Lkv, D)`` with
any Lq and Lkv.  The CUDA kernel (``csrc/streaming_attention.cu``) picks its
own tiles (64 query rows by 64 key rows) and masks ragged tails itself, so
nothing is padded or copied: q, k and v may be strided views (the
head-split projections of the model), and the output keeps q's memory
layout.  The reference pads to its TPU blocks instead; results agree within
the f32 tolerance, not bit for bit, because the online softmax rescales at
other block edges.

CPU tensors take the plain version (``ref.py``); CUDA tensors launch the
kernel or raise.  One C entry point holds two kernels, chosen by dtype
(``kernel_variant``): bf16 runs on the tensor cores, f32 on the CUDA cores.
``streaming_attention.launches`` counts kernel launches, and
``streaming_attention.launches_by_variant`` the same launches per kernel.
The kernel is forward only: asking autograd for a gradient through it
raises ``NotImplementedError`` (the backward kernel is the training slice's
work); on the CPU the plain version is ordinary torch and differentiates.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.lut_exp.ops import device_table
from repro_torch.kernels.lut_exp.ref import lut_exp_ref
from repro_torch.kernels.streaming_attention.ref import attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# dtype → the kernel the C entry point launches for it
VARIANTS = {torch.bfloat16: "tensor_core", torch.float32: "cuda_core"}
_EXP_MODES = {"lut": 0, "lut0": 1, "exact": 2}
HEAD_DIMS = (8, 16, 32, 64, 128)
BLOCK_K = 64          # key rows per kv tile (the kernel's online-softmax step)
MAX_HEAD_BATCH = 65535


def kernel_variant(dtype: torch.dtype, d: int) -> str:
    """Which kernel a CUDA call with this dtype and head dim launches:
    ``"tensor_core"`` (bf16: mma.sync, head dims 8–128, 8 zero-filled to
    16) or ``"cuda_core"`` (f32).  Raises on what neither kernel takes."""
    if dtype not in VARIANTS:
        raise TypeError(f"streaming_attention kernel: q, k, v must share "
                        f"float32 or bfloat16, got {dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"streaming_attention kernel: head dim {d} not in "
                         f"{HEAD_DIMS}")
    return VARIANTS[dtype]


def _library() -> ctypes.CDLL:
    lib = build.load("streaming_attention")
    fn = lib.streaming_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    ex = lib.streaming_attention_exp_launch
    ex.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_void_p]
    ex.restype = ctypes.c_int
    return lib


def softmax_exp(x: torch.Tensor, *, order: int = 1) -> torch.Tensor:
    """The LUT exponential as the tensor-core kernel's softmax evaluates it
    (``lut_exp_nonpos`` in ``csrc/lut_exp.cuh``: no conversion
    instructions), elementwise over f32: on the card, the check that it is
    the plain LUT bit for bit for x <= 0.  CPU tensors take the plain LUT.
    Not a main-path launch; not counted."""
    if x.device.type == "cpu":
        return lut_exp_ref(x, order=order)
    if x.device.type != "cuda":
        raise ValueError(f"softmax_exp: unsupported device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous() or order not in (0, 1):
        raise ValueError(f"softmax_exp takes a contiguous float32 tensor and "
                         f"order 0 or 1, got {x.dtype}, order {order}")
    lib = _library()
    out = torch.empty_like(x)
    err = lib.streaming_attention_exp_launch(
        x.data_ptr(), out.data_ptr(), device_table(x.device).data_ptr(),
        x.numel(), order, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "streaming_attention_exp launch")
    return out


def _check_cuda(q, k, v, cap, window, exp_mode, q_offset, kv_len):
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"streaming_attention: {name} on {t.device}, "
                             f"q on {q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"streaming_attention kernel: q, k, v must share "
                        f"float32 or bfloat16, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"streaming_attention kernel: q (B, Hq, Lq, D) and "
                         f"equal k, v (B, Hkv, Lkv, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(f"streaming_attention kernel: k/v {tuple(k.shape)} "
                         f"do not match q {tuple(q.shape)} (GQA needs Hq % "
                         f"Hkv == 0)")
    kernel_variant(q.dtype, d)
    if b * hq > MAX_HEAD_BATCH:
        raise ValueError(f"streaming_attention kernel: B·Hq = {b * hq} > "
                         f"{MAX_HEAD_BATCH}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("streaming_attention kernel: the head dim of q, k, "
                         "v must be contiguous")
    if cap is not None and not cap > 0:
        raise ValueError(f"streaming_attention kernel: softcap must be > 0, "
                         f"got {cap}")
    if window is not None and not window > 0:
        raise ValueError(f"streaming_attention kernel: window must be > 0, "
                         f"got {window}")
    if exp_mode not in _EXP_MODES:
        raise ValueError(f"exp_mode must be one of {sorted(_EXP_MODES)}, "
                         f"got {exp_mode!r}")
    for name, x in (("q_offset", q_offset), ("kv_len", kv_len)):
        if x is not None and (not isinstance(x, int) or x < 0):
            raise TypeError(f"streaming_attention kernel: {name} must be a "
                            f"static int >= 0, got {x!r}")


def _launch(q, k, v, *, scale, causal, window, cap, exp_mode, q_offset,
            kv_len):
    b, hq, lq, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    lib = _library()
    out = torch.empty_like(q)
    err = lib.streaming_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        device_table(q.device).data_ptr(), out.data_ptr(),
        b, hq, hkv, lq, lkv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        q_offset, lkv if kv_len is None else min(kv_len, lkv), int(causal),
        int(window or 0), float(scale), float(cap or 0.0),
        _EXP_MODES[exp_mode], _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "streaming_attention launch")
    streaming_attention.launches += 1
    streaming_attention.launches_by_variant[kernel_variant(q.dtype, d)] += 1
    return out


class _ForwardOnly(torch.autograd.Function):
    """The kernel under autograd: the forward launches it, a backward
    raises."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        return _launch(q, k, v, **kw)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "streaming_attention: the CUDA kernel is forward only; its "
            "backward kernel lands with the training slice of the PyTorch "
            "port (ROADMAP.md)")


def streaming_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        scale: Optional[float] = None, causal: bool = False,
                        window: Optional[int] = None,
                        cap: Optional[float] = None, exp_mode: str = "lut",
                        q_offset: int = 0,
                        kv_len: Optional[int] = None) -> torch.Tensor:
    """HASTILY streaming attention, kernel path.

    q (B, Hq, Lq, D); k, v (B, Hkv, Lkv, D), Hq % Hkv == 0.  ``q_offset``
    (the position of row 0) and ``kv_len`` (keys at or past it are masked)
    are static ints, as the reference's kernel requires.  → (B, Hq, Lq, D)
    in q's dtype.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    kw = dict(scale=float(scale), causal=causal, window=window, cap=cap,
              exp_mode=exp_mode, q_offset=q_offset, kv_len=kv_len)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"streaming_attention: unsupported device {q.device}")
    _check_cuda(q, k, v, cap, window, exp_mode, q_offset, kv_len)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _ForwardOnly.apply(q, k, v, kw)
    return _launch(q, k, v, **kw)


streaming_attention.launches = 0
streaming_attention.launches_by_variant = dict.fromkeys(VARIANTS.values(), 0)
