from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.paged_attention.ref import (default_block_pages,
                                                     paged_attention_reference)
from repro_torch.kernels.paged_attention.varlen import (
    paged_attention_varlen, paged_attention_varlen_reference, q_block_layout,
    validate_cu_seqlens, varlen_positions)

__all__ = ["paged_attention", "paged_attention_reference",
           "default_block_pages", "paged_attention_varlen",
           "paged_attention_varlen_reference", "q_block_layout",
           "validate_cu_seqlens", "varlen_positions"]
