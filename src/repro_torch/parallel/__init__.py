"""Parallelism of the port: the sharding rules (port of
``src/repro/parallel/sharding.py``), the activation-sharding context
(``ctx.py``), the collectives over a mesh axis and their autograd forms
(``collectives.py``), the gradient compression with error feedback and
the bf16 sum over an axis (``grad_compress.py``), and the GPipe stage
schedule (``pipeline.py``)."""
from repro_torch.parallel.ctx import activation_sharding, active_mesh, maybe_shard
from repro_torch.parallel.grad_compress import (compress_with_feedback,
                                                compressed_psum, decompress,
                                                feedback_init)
from repro_torch.parallel.pipeline import pipeline_apply, stack_stages
from repro_torch.parallel.sharding import (batch_specs, cache_specs,
                                           cache_specs_decode, fit_spec,
                                           logical_axes, param_pspec,
                                           param_specs, shard_tree,
                                           shardings_of)

__all__ = ["param_specs", "param_pspec", "batch_specs", "cache_specs",
           "cache_specs_decode",
           "fit_spec", "logical_axes", "shard_tree", "shardings_of",
           "compress_with_feedback", "compressed_psum", "decompress",
           "feedback_init", "pipeline_apply", "stack_stages",
           "activation_sharding", "active_mesh", "maybe_shard"]
