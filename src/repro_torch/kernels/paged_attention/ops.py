"""Public paged-attention entry point (port of
``src/repro/kernels/paged_attention/ops.py``).

Takes the serving layout directly — q ``(B, Hq, Lq, D)``, page pools
``(N, Hkv, page_size, D)``, a page table ``(B, P)`` and per-lane live
lengths ``(B,)`` — and hands the pool straight to the kernel with no copies.
CPU tensors take the plain version (``ref.py``); CUDA tensors launch
``csrc/paged_attention.cu`` or raise.  ``paged_attention.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.lut_exp.ops import device_table
from repro_torch.kernels.paged_attention.ref import paged_attention_reference

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_EXP_MODES = {"lut": 0, "lut0": 1, "exact": 2}
MAX_HEAD_DIM = 256
MAX_ROW_TILE = 16     # query rows per block
MAX_KEY_TILE = 32     # pool rows staged per step


def _library() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    fn = lib.paged_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_float]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check_cuda(q, k_pool, v_pool, page_table, kv_len, k_scale, v_scale,
                cap, window, exp_mode):
    dev = q.device
    named = dict(k_pool=k_pool, v_pool=v_pool, page_table=page_table,
                 kv_len=kv_len, k_scale=k_scale, v_scale=v_scale)
    for name, t in named.items():
        if t is not None and t.device != dev:
            raise ValueError(f"paged_attention: {name} on {t.device}, q on {dev}")
        if t is not None and not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"paged_attention kernel: q must be float32 or "
                        f"bfloat16, got {q.dtype}")
    if k_pool.dtype not in _KV_DTYPES or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"paged_attention kernel: pools must share one of "
                        f"float32/bfloat16/int8, got {k_pool.dtype}, "
                        f"{v_pool.dtype}")
    if k_pool.shape != v_pool.shape or k_pool.dim() != 4:
        raise ValueError(f"paged_attention kernel: pools must be equal "
                         f"(N, Hkv, ps, D), got {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)}")
    quantized = k_pool.dtype == torch.int8
    if quantized != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("paged_attention kernel: int8 pools need both "
                         "k_scale and v_scale, float pools take neither")
    if quantized:
        for s in (k_scale, v_scale):
            if s.dtype != torch.float32 or s.shape != k_pool.shape[:3]:
                raise ValueError(f"paged_attention kernel: scales must be f32 "
                                 f"{tuple(k_pool.shape[:3])}, got {s.dtype} "
                                 f"{tuple(s.shape)}")
    if page_table.dtype != torch.int32 or kv_len.dtype != torch.int32:
        raise TypeError("paged_attention kernel: page_table and kv_len must "
                        "be int32")
    if q.shape[-1] != k_pool.shape[-1] or q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"paged_attention kernel: head dim {q.shape[-1]} "
                         f"vs pool {k_pool.shape[-1]} (at most {MAX_HEAD_DIM})")
    ps = k_pool.shape[2]
    if ps > MAX_KEY_TILE and ps % MAX_KEY_TILE:
        raise ValueError(f"paged_attention kernel: page size {ps} > "
                         f"{MAX_KEY_TILE} must be a multiple of {MAX_KEY_TILE}")
    if cap is not None and not cap > 0:
        raise ValueError(f"paged_attention kernel: softcap must be > 0, got {cap}")
    if window is not None and not window > 0:
        raise ValueError(f"paged_attention kernel: window must be > 0, got {window}")
    if exp_mode not in _EXP_MODES:
        raise ValueError(f"exp_mode must be one of {sorted(_EXP_MODES)}, "
                         f"got {exp_mode!r}")


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, page_table: torch.Tensor, kv_len, *,
                    scale: Optional[float] = None,
                    cap: Optional[float] = None,
                    window: Optional[int] = None,
                    exp_mode: str = "lut",
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None,
                    block_pages: Optional[int] = None,
                    dequant: str = "block") -> torch.Tensor:
    """Attention through the page table: decode row or prefill chunk.

    q (B, Hq, Lq, D) — row ``i`` sits at position ``kv_len - Lq + i``;
    pools (N, Hkv, ps, D); page_table (B, P) int32; kv_len (B,) int32 or an
    int.  ``block_pages`` and ``dequant`` shape only the plain version's
    scan: the kernel walks and dequantises one page at a time.
    """
    b, hq, lq, d = q.shape
    hkv = k_pool.shape[1]
    assert hq % hkv == 0, f"GQA requires Hq % Hkv == 0, got {hq} % {hkv}"
    if scale is None:
        scale = d ** -0.5
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, k_pool, v_pool, page_table, kv_len, scale=float(scale),
            cap=cap, window=window, exp_mode=exp_mode, k_scale=k_scale,
            v_scale=v_scale, block_pages=block_pages, dequant=dequant)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    if not torch.is_tensor(kv_len):
        kv_len = torch.full((b,), int(kv_len), dtype=torch.int32,
                            device=q.device)
    _check_cuda(q, k_pool, v_pool, page_table, kv_len, k_scale, v_scale,
                cap, window, exp_mode)
    if not q.is_contiguous():
        raise ValueError("paged_attention: q must be contiguous")
    if page_table.shape[0] != b or kv_len.shape != (b,):
        raise ValueError(f"paged_attention: page_table {tuple(page_table.shape)}"
                         f" / kv_len {tuple(kv_len.shape)} vs batch {b}")
    g = hq // hkv
    rows = g * lq
    ps = k_pool.shape[2]
    row_tile, key_tile = min(rows, MAX_ROW_TILE), min(ps, MAX_KEY_TILE)
    lib = _library()
    out = torch.empty((b, hkv, rows, d), dtype=q.dtype, device=q.device)
    err = lib.paged_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        None if k_scale is None else k_scale.data_ptr(),
        None if v_scale is None else v_scale.data_ptr(),
        page_table.data_ptr(), kv_len.data_ptr(),
        device_table(q.device).data_ptr(), out.data_ptr(),
        b, hkv, rows, d, ps, page_table.shape[1], lq, row_tile, key_tile,
        float(scale), float(cap or 0.0), int(window or 0),
        _EXP_MODES[exp_mode], _Q_DTYPES[q.dtype], _KV_DTYPES[k_pool.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "paged_attention launch")
    paged_attention.launches += 1
    return out.reshape(b, hq, lq, d)


paged_attention.launches = 0
