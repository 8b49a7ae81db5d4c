"""Plain PyTorch math shared by the kernels' references and the model:
``lut_exp`` (the LUT exponential), ``lut_softmax`` (mask value, softcap,
the LUT softmax), ``streaming_attention`` (the online-softmax scan, the
materialised oracle, int8 KV-row quantisation) and ``attention_api`` (the
attention backend registry)."""
