"""Plain PyTorch math shared by the kernels' references and the model:
``lut_exp`` (the LUT exponential), ``lut_softmax`` (mask value, softcap)
and ``streaming_attention`` (int8 KV-row quantisation)."""
