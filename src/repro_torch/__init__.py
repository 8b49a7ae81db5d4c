"""PyTorch/CUDA port of the HASTILY serving system for NVIDIA Hopper.

A package of its own beside the JAX reference (``src/repro``): it imports
``torch``, numpy and the standard library, never JAX and never the
reference package.  It serves the dense decoder (``deepseek-7b``) through
``serving.EngineCore`` in ragged mode, with paged attention in a
hand-written CUDA kernel that inlines the paper's LUT exponential, and
runs the cache-free full-sequence forward (BERT encoding, causal scoring)
through ``models.api.build_model`` and a hand-written CUDA
streaming-attention kernel (``csrc/``).  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``, where every kernel wrapper
takes its plain PyTorch version.
"""
