"""Parallelism of the port: the sharding rules (port of
``src/repro/parallel/sharding.py``), the activation-sharding context
(``ctx.py``), the collectives over a mesh axis (``collectives.py``) and
the gradient compression with error feedback (``grad_compress.py``).
``compressed_psum`` and the pipeline come with the training half of
tensor parallelism (ROADMAP.md §1 items 5 and 6)."""
from repro_torch.parallel.ctx import activation_sharding, active_mesh, maybe_shard
from repro_torch.parallel.grad_compress import (compress_with_feedback,
                                                decompress, feedback_init)
from repro_torch.parallel.sharding import (batch_specs, cache_specs,
                                           cache_specs_decode, fit_spec,
                                           logical_axes, param_pspec,
                                           param_specs, shard_tree,
                                           shardings_of)

__all__ = ["param_specs", "param_pspec", "batch_specs", "cache_specs",
           "cache_specs_decode",
           "fit_spec", "logical_axes", "shard_tree", "shardings_of",
           "compress_with_feedback", "decompress", "feedback_init",
           "activation_sharding", "active_mesh", "maybe_shard"]
