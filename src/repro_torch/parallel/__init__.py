"""Parallelism of the port: so far the gradient compression with error
feedback (port of ``src/repro/parallel/grad_compress.py``).  The sharding
rules, ``compressed_psum`` and the mesh context come with tensor-parallel
serving, the pipeline with a later training slice (ROADMAP.md §1)."""
from repro_torch.parallel.grad_compress import (compress_with_feedback,
                                                decompress, feedback_init)

__all__ = ["compress_with_feedback", "decompress", "feedback_init"]
