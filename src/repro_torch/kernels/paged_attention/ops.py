"""Public paged-attention entry point (port of
``src/repro/kernels/paged_attention/ops.py``).

Takes the serving layout directly — q ``(B, Hq, Lq, D)``, page pools
``(N, Hkv, page_size, D)``, a page table ``(B, P)`` and per-lane live
lengths ``(B,)`` — and hands the pool straight to the kernel with no copies.
CPU tensors take the plain version (``ref.py``); CUDA tensors launch
``csrc/paged_attention.cu`` or raise: a split-KV pass (each block walks at
most ``kv_split`` pages of one lane and writes f32 partials to a workspace)
and ``paged_combine``, which merges each row's live splits.  The number of
splits follows the table's width alone, so a call reads no device value on
the host.  ``paged_attention.launches`` counts split passes (one per call),
``paged_attention.combine_launches`` combine passes.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.lut_exp.ops import device_table
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_reference, paged_combine_reference)

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_EXP_MODES = {"lut": 0, "lut0": 1, "exact": 2}
MAX_HEAD_DIM = 256
MAX_ROW_TILE = 16     # query rows per block
MAX_KEY_TILE = 32     # pool rows staged per step
# Keys per split of the kernel's default: the best of 64, 128 and 256 at
# the deepseek-7b decode step on an H100 (4 pages at page size 16; PERF.md).
KV_SPLIT_KEYS = 64


def default_kv_split(page_size: int) -> int:
    """The kernel's pages per split when a call names none: about
    ``KV_SPLIT_KEYS`` keys."""
    return max(1, KV_SPLIT_KEYS // max(page_size, 1))


_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = build.load("paged_attention")
    fn = lib.paged_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_float]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.paged_combine_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib = lib
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
                    dequant: str = "block",
                    kv_split: Optional[int] = None) -> torch.Tensor:
    """Attention through the page table: decode row or prefill chunk.

    q (B, Hq, Lq, D) — row ``i`` sits at position ``kv_len - Lq + i``;
    pools (N, Hkv, ps, D); page_table (B, P) int32; kv_len (B,) int32 or an
    int.  ``block_pages`` and ``dequant`` shape only the plain version's
    scan: the kernel walks and dequantises one page at a time.
    ``kv_split`` is pages per split: the kernel's default is
    :func:`default_kv_split`, the plain version's ``None`` no split.
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
            v_scale=v_scale, block_pages=block_pages, dequant=dequant,
            kv_split=kv_split)
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
    ps, slots = k_pool.shape[2], page_table.shape[1]
    if kv_split is None:
        kv_split = default_kv_split(ps)
    if kv_split < 1 or slots < 1:
        raise ValueError(f"paged_attention kernel: kv_split {kv_split} and "
                         f"table width {slots} must be >= 1")
    splits = -(-slots // kv_split)
    row_tile, key_tile = min(rows, MAX_ROW_TILE), min(ps, MAX_KEY_TILE)
    lib = _library()
    # one f32 workspace: acc (B, Hkv, S, R, D), then m and l (B, Hkv, S, R)
    n_ml = b * hkv * splits * rows
    ws = torch.empty((n_ml * (d + 2),), dtype=torch.float32, device=q.device)
    acc_p = ws.data_ptr()
    m_p, l_p = acc_p + 4 * n_ml * d, acc_p + 4 * n_ml * (d + 1)
    table = device_table(q.device).data_ptr()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        None if k_scale is None else k_scale.data_ptr(),
        None if v_scale is None else v_scale.data_ptr(),
        page_table.data_ptr(), kv_len.data_ptr(), table, m_p, l_p, acc_p,
        b, hkv, rows, d, ps, slots, lq, row_tile, key_tile, kv_split,
        float(scale), float(cap or 0.0), int(window or 0),
        _EXP_MODES[exp_mode], _Q_DTYPES[q.dtype], _KV_DTYPES[k_pool.dtype],
        stream)
    build.check(lib, err, "paged_attention launch")
    paged_attention.launches += 1
    out = torch.empty((b, hq, lq, d), dtype=q.dtype, device=q.device)
    _launch_combine(lib, m_p, l_p, acc_p, kv_len.data_ptr(), table,
                    out.data_ptr(), b, hkv, rows, d, ps, kv_split, splits,
                    _EXP_MODES[exp_mode], _Q_DTYPES[q.dtype], stream)
    return out


def _launch_combine(lib, m_p, l_p, acc_p, kv_len_p, table_p, out_p, *dims):
    """Launch the combine on raw pointers, unchecked: ``paged_attention``
    has checked its own workspace, and ``paged_combine`` checks its
    arguments before it calls this."""
    build.check(lib, lib.paged_combine_launch(m_p, l_p, acc_p, kv_len_p,
                                              table_p, out_p, *dims),
                "paged_combine launch")
    paged_attention.combine_launches += 1


paged_attention.launches = 0
paged_attention.combine_launches = 0


def paged_combine(part_m: torch.Tensor, part_l: torch.Tensor,
                  part_acc: torch.Tensor, kv_len: torch.Tensor, *,
                  page_size: int, kv_split: int, exp_mode: str = "lut",
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Merge split partials → (B, Hkv, R, D) in ``dtype``.

    part_m, part_l (B, Hkv, S, R) and part_acc (B, Hkv, S, R, D) f32: split
    s's running max, sum and unnormalised accumulator; lane b's live splits
    are the first ⌈⌈kv_len[b] / page_size⌉ / kv_split⌉ (at most S), and the
    others are never read.  CPU tensors take ``paged_combine_reference``;
    CUDA tensors launch the combine kernel (counted in
    ``paged_attention.combine_launches``) or raise."""
    if part_m.device.type == "cpu":
        return paged_combine_reference(part_m, part_l, part_acc, kv_len,
                                       page_size=page_size, kv_split=kv_split,
                                       exp_mode=exp_mode).to(dtype)
    if part_m.device.type != "cuda":
        raise ValueError(f"paged_combine: unsupported device {part_m.device}")
    b, hkv, splits, rows, d = part_acc.shape
    for name, t in dict(part_m=part_m, part_l=part_l, part_acc=part_acc).items():
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != part_m.device:
            raise ValueError(f"paged_combine: {name} must be contiguous f32 "
                             f"on {part_m.device}")
    if part_m.shape != (b, hkv, splits, rows) or part_l.shape != part_m.shape:
        raise ValueError(f"paged_combine: partials {tuple(part_m.shape)}, "
                         f"{tuple(part_l.shape)} vs acc {tuple(part_acc.shape)}")
    if kv_len.dtype != torch.int32 or kv_len.shape != (b,) \
            or kv_len.device != part_m.device:
        raise ValueError("paged_combine: kv_len must be (B,) int32 on the "
                         "partials' device")
    if dtype not in _Q_DTYPES or d > MAX_HEAD_DIM or exp_mode not in _EXP_MODES:
        raise ValueError(f"paged_combine: dtype {dtype}, head dim {d} (at "
                         f"most {MAX_HEAD_DIM}), exp_mode {exp_mode!r}")
    lib = _library()
    out = torch.empty((b, hkv, rows, d), dtype=dtype, device=part_m.device)
    _launch_combine(lib, part_m.data_ptr(), part_l.data_ptr(),
                    part_acc.data_ptr(), kv_len.data_ptr(),
                    device_table(part_m.device).data_ptr(), out.data_ptr(),
                    b, hkv, rows, d, page_size, kv_split, splits,
                    _EXP_MODES[exp_mode], _Q_DTYPES[dtype],
                    torch.cuda.current_stream(part_m.device).cuda_stream)
    return out
