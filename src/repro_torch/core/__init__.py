"""Plain PyTorch math shared by the kernels' references and the model:
``lut_exp`` (the LUT exponential), ``lut_softmax`` (mask value, softcap,
the LUT softmax), ``streaming_attention`` (the online-softmax scan, the
materialised oracle, int8 KV-row quantisation), ``attention_api`` (the
attention backend registry) and ``quant`` (the INT8 substrate: ``QTensor``,
symmetric quantisation, the int8 matmul and its dispatch point).  The
names are the reference's ``repro.core`` exports, less the multi-chip
softmax and ring attention, which come with tensor-parallel serving."""
from repro_torch.core.attention_api import (attention, backend_for_config,
                                            get_backend, list_backends,
                                            register_backend, resolve_backend)
from repro_torch.core.lut_exp import K, lut_exp, lut_exp2, make_table
from repro_torch.core.lut_softmax import lut_log_softmax, lut_softmax, softcap
from repro_torch.core.quant import (QTensor, dense_maybe_quant, int8_matmul,
                                    quantize, quantize_dynamic)
from repro_torch.core.streaming_attention import (naive_attention,
                                                  streaming_attention)

__all__ = [
    "lut_exp", "lut_exp2", "make_table", "K",
    "lut_softmax", "lut_log_softmax", "softcap",
    "streaming_attention", "naive_attention",
    "attention", "backend_for_config", "get_backend", "list_backends",
    "register_backend", "resolve_backend",
    "QTensor", "quantize", "quantize_dynamic", "int8_matmul",
    "dense_maybe_quant",
]
