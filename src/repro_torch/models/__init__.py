"""Models of the port: layers, the LM (cache-free forward, cached path and
ragged serving step), the encoder-decoder and ``api.build_model``."""
from repro_torch.models.api import (Model, batch_specs, build_model,
                                    cache_specs, init_params, input_specs)

__all__ = ["Model", "build_model", "init_params", "input_specs",
           "batch_specs", "cache_specs"]
