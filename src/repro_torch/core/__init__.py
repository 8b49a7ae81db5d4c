"""Plain PyTorch math shared by the kernels' references and the model:
``lut_exp`` (the LUT exponential), ``lut_softmax`` (mask value, softcap,
the LUT softmax), ``streaming_attention`` (the online-softmax scan, the
materialised oracle, int8 KV-row quantisation), ``attention_api`` (the
attention backend registry) and ``quant`` (the INT8 substrate: ``QTensor``,
symmetric quantisation, the int8 matmul and its dispatch point)."""
from repro_torch.core.quant import (QTensor, dense_maybe_quant, int8_matmul,
                                    quantize, quantize_dynamic)

__all__ = ["QTensor", "quantize", "quantize_dynamic", "int8_matmul",
           "dense_maybe_quant"]
