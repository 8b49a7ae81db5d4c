"""Public streaming-attention entry point (port of
``src/repro/kernels/streaming_attention/ops.py``).

Takes the model layout q ``(B, Hq, Lq, D)``, k/v ``(B, Hkv, Lkv, D)`` with
any Lq and Lkv.  The CUDA kernel (``csrc/streaming_attention.cu``) picks its
own tiles (64 query rows by 64 key rows, 32 key rows for bf16 at head
dim 256) and masks ragged tails itself, so
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

Under autograd the call is one ``torch.autograd.Function`` (``_Attention``,
the counterpart of the reference's ``_pallas`` custom VJP): its forward
asks the kernel for the f32 per-row logsumexp too, and saves q, k, v, out
and lse — nothing of size Lq × Lkv; its backward is the hand-written
backward kernel (``csrc/streaming_attention_bwd.cu``, the reference's
``_bwd``: δ, dK/dV, dQ, no atomics) through ``streaming_attention_bwd``,
counted in ``streaming_attention_bwd.launches`` (one per backward call
of three kernels, four for bf16 at head dim 256, where dV and dK are
launched apart) and ``.launches_by_variant`` (``BWD_VARIANTS``: bf16 on
the tensor cores, f32 on the CUDA cores, as the forward), at every head
dim the forward takes (``BWD_HEAD_DIMS``).  On the CPU the same Function
runs the plain forward and backward of ``ref.py``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.lut_exp.ops import device_table
from repro_torch.kernels.lut_exp.ref import lut_exp_ref
from repro_torch.kernels.streaming_attention.ref import (attention_bwd_ref,
                                                        attention_lse_ref,
                                                        attention_ref)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# dtype → the kernel the C entry point launches for it
VARIANTS = {torch.bfloat16: "tensor_core", torch.float32: "cuda_core"}
_EXP_MODES = {"lut": 0, "lut0": 1, "exact": 2}
HEAD_DIMS = (8, 16, 32, 64, 128, 256)
BWD_HEAD_DIMS = HEAD_DIMS   # the backward kernel's
# dtype → the backward kernels the C entry point launches for it
BWD_VARIANTS = {torch.bfloat16: "tensor_core", torch.float32: "cuda_core"}
BLOCK_K = 64          # key rows per kv tile (the kernel's online-softmax step)
MAX_HEAD_BATCH = 65535


def block_k(dtype: torch.dtype, d: int) -> int:
    """Key rows per kv tile of the kernel a CUDA call launches: ``BLOCK_K``,
    save the bf16 kernel at head dim 256, whose registers hold 32-key
    tiles (the blocking a plain scan must copy to hold ``lut0``)."""
    return 32 if dtype == torch.bfloat16 and d > 128 else BLOCK_K


def kernel_variant(dtype: torch.dtype, d: int) -> str:
    """Which kernel a CUDA call with this dtype and head dim launches:
    ``"tensor_core"`` (bf16: mma.sync, head dims 8–256, 8 zero-filled to
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
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
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
    build.refuse_grad("softmax_exp", x)
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
            kv_len, lse=False):
    """One forward launch → out, or (out, the f32 (B, Hq, Lq) logsumexp)
    with ``lse``."""
    b, hq, lq, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    lib = _library()
    out = torch.empty_like(q)
    lse_t = (torch.empty((b, hq, lq), dtype=torch.float32, device=q.device)
             if lse else None)
    err = lib.streaming_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        device_table(q.device).data_ptr(), out.data_ptr(),
        None if lse_t is None else lse_t.data_ptr(),
        b, hq, hkv, lq, lkv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        q_offset, lkv if kv_len is None else min(kv_len, lkv), int(causal),
        int(window or 0), float(scale), float(cap or 0.0),
        _EXP_MODES[exp_mode], _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "streaming_attention launch")
    streaming_attention.launches += 1
    streaming_attention.launches_by_variant[kernel_variant(q.dtype, d)] += 1
    return out if lse_t is None else (out, lse_t)


def _bwd_library() -> ctypes.CDLL:
    lib = build.load("streaming_attention_bwd")
    fn = lib.streaming_attention_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 24 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _launch_bwd(q, k, v, out, lse, dout, *, scale, causal, window, cap,
                exp_mode, q_offset, kv_len):
    b, hq, lq, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    lib = _bwd_library()
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in (q, k, v))
    delta = torch.empty((b, hq, lq), dtype=torch.float32, device=q.device)
    err = lib.streaming_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), dout.data_ptr(), device_table(q.device).data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, hq, hkv, lq, lkv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        *dout.stride()[:3], *dq.stride()[:3], *dk.stride()[:3],
        *dv.stride()[:3],
        q_offset, lkv if kv_len is None else min(kv_len, lkv), int(causal),
        int(window or 0), float(scale), float(cap or 0.0),
        _EXP_MODES[exp_mode], _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "streaming_attention_bwd launch")
    streaming_attention_bwd.launches += 1
    streaming_attention_bwd.launches_by_variant[BWD_VARIANTS[q.dtype]] += 1
    return dq, dk, dv


def _check_bwd(q, k, v, out, lse, dout, kw):
    """The backward kernel's checks → (out, dout) with a contiguous head
    dim."""
    _check_cuda(q, k, v, kw["cap"], kw["window"], kw["exp_mode"],
                kw["q_offset"], kw["kv_len"])
    for name, t, dt in (("out", out, q.dtype), ("dout", dout, q.dtype),
                        ("lse", lse, torch.float32)):
        if t.device != q.device or t.dtype != dt:
            raise TypeError(f"streaming_attention_bwd: {name} must be {dt} "
                            f"on {q.device}, got {t.dtype} on {t.device}")
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"streaming_attention_bwd: out {tuple(out.shape)} "
                         f"and dout {tuple(dout.shape)} must be q's "
                         f"{tuple(q.shape)}")
    if lse.shape != q.shape[:3] or not lse.is_contiguous():
        raise ValueError(f"streaming_attention_bwd: lse must be a "
                         f"contiguous {tuple(q.shape[:3])}, got "
                         f"{tuple(lse.shape)}")
    return tuple(t if t.stride(-1) == 1 else t.contiguous()
                 for t in (out, dout))


class _Attention(torch.autograd.Function):
    """The kernel under autograd: forward with ``lse``, backward kernel
    (the plain versions of ``ref.py`` on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        if q.device.type == "cpu":
            out, lse = attention_lse_ref(q, k, v, **kw)
        else:
            out, lse = _launch(q, k, v, lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*streaming_attention_bwd(q, k, v, out, lse, dout, **ctx.kw),
                None)


def streaming_attention_bwd(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor, *,
                            scale: float, causal: bool = False,
                            window: Optional[int] = None,
                            cap: Optional[float] = None,
                            exp_mode: str = "lut", q_offset: int = 0,
                            kv_len: Optional[int] = None):
    """The backward of the streaming-attention kernel → (dq, dk, dv) in
    q's, k's and v's dtypes: the backward kernel on the card, the plain
    backward (``attention_bwd_ref``) on the CPU.  ``out`` (B, Hq, Lq, D)
    and ``lse`` (B, Hq, Lq) f32 are the forward's, ``dout`` out's
    gradient."""
    kw = dict(scale=scale, causal=causal, window=window, cap=cap,
              exp_mode=exp_mode, q_offset=q_offset, kv_len=kv_len)
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"streaming_attention_bwd: unsupported device "
                         f"{q.device}")
    out, dout = _check_bwd(q, k, v, out, lse, dout, kw)
    return _launch_bwd(q, k, v, out, lse, dout, **kw)


def streaming_attention_lse(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, scale: Optional[float] = None,
                            causal: bool = False,
                            window: Optional[int] = None,
                            cap: Optional[float] = None,
                            exp_mode: str = "lut", q_offset: int = 0,
                            kv_len: Optional[int] = None):
    """The forward as the backward needs it → (out, f32 lse (B, Hq, Lq)):
    one kernel launch on the card, ``attention_lse_ref`` on the CPU."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    kw = dict(scale=float(scale), causal=causal, window=window, cap=cap,
              exp_mode=exp_mode, q_offset=q_offset, kv_len=kv_len)
    if q.device.type == "cpu":
        return attention_lse_ref(q, k, v, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"streaming_attention: unsupported device {q.device}")
    _check_cuda(q, k, v, cap, window, exp_mode, q_offset, kv_len)
    return _launch(q, k, v, lse=True, **kw)


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
    in q's dtype, differentiable (``_Attention``).
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    kw = dict(scale=float(scale), causal=causal, window=window, cap=cap,
              exp_mode=exp_mode, q_offset=q_offset, kv_len=kv_len)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if q.device.type == "cpu":
        return _Attention.apply(q, k, v, kw) if grad else attention_ref(
            q, k, v, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"streaming_attention: unsupported device {q.device}")
    _check_cuda(q, k, v, cap, window, exp_mode, q_offset, kv_len)
    if grad:
        return _Attention.apply(q, k, v, kw)
    return _launch(q, k, v, **kw)


streaming_attention.launches = 0
streaming_attention.launches_by_variant = dict.fromkeys(VARIANTS.values(), 0)
streaming_attention_bwd.launches = 0
streaming_attention_bwd.launches_by_variant = dict.fromkeys(
    BWD_VARIANTS.values(), 0)
