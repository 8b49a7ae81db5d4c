"""Plain PyTorch math shared by the kernels' references and the model:
``lut_exp`` (the LUT exponential), ``lut_softmax`` (mask value, softcap,
the LUT softmax), ``streaming_attention`` (the online-softmax scan, the
materialised oracle, int8 KV-row quantisation), ``attention_api`` (the
attention backend registry), ``multicore_softmax`` / ``ring_attention``
(the paper's multi-core softmax and attention over a sequence split
across the ranks of a mesh axis, §III-B2) and ``quant`` (the INT8
substrate: ``QTensor``, symmetric quantisation, the int8 matmul and its
dispatch point).  The names are the reference's ``repro.core``
exports."""
from repro_torch.core.attention_api import (attention, backend_for_config,
                                            get_backend, list_backends,
                                            register_backend, resolve_backend)
from repro_torch.core.lut_exp import K, lut_exp, lut_exp2, make_table
from repro_torch.core.lut_softmax import lut_log_softmax, lut_softmax, softcap
from repro_torch.core.multicore_softmax import (sharded_softmax,
                                                sharded_softmax_tree,
                                                tree_allreduce)
from repro_torch.core.quant import (QTensor, dense_maybe_quant, int8_matmul,
                                    quantize, quantize_dynamic)
from repro_torch.core.ring_attention import (distributed_decode_attention,
                                             ring_attention)
from repro_torch.core.streaming_attention import (naive_attention,
                                                  streaming_attention)

__all__ = [
    "lut_exp", "lut_exp2", "make_table", "K",
    "lut_softmax", "lut_log_softmax", "softcap",
    "streaming_attention", "naive_attention",
    "attention", "backend_for_config", "get_backend", "list_backends",
    "register_backend", "resolve_backend",
    "ring_attention", "distributed_decode_attention",
    "sharded_softmax", "sharded_softmax_tree", "tree_allreduce",
    "QTensor", "quantize", "quantize_dynamic", "int8_matmul",
    "dense_maybe_quant",
]
