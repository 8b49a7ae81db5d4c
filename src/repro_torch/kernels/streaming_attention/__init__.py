from repro_torch.kernels.streaming_attention.ops import streaming_attention
from repro_torch.kernels.streaming_attention.ref import attention_ref

__all__ = ["streaming_attention", "attention_ref"]
