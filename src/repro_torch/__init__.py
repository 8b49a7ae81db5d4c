"""PyTorch/CUDA port of the HASTILY serving system for NVIDIA Hopper.

A package of its own beside the JAX reference (``src/repro``): it imports
``torch``, numpy and the standard library, never JAX and never the
reference package.  This slice serves the dense decoder (``deepseek-7b``)
through ``serving.EngineCore`` in ragged mode, with paged attention in a
hand-written CUDA kernel that inlines the paper's LUT exponential
(``csrc/``).  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``, where every kernel wrapper takes its plain PyTorch
version.
"""
