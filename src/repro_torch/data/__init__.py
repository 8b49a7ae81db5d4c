"""The port's data pipeline (port of ``src/repro/data``)."""
from repro_torch.data.pipeline import DataConfig, TokenPipeline, host_shard

__all__ = ["DataConfig", "TokenPipeline", "host_shard"]
