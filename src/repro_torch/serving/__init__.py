"""Request-level serving for the port: EngineCore over a paged KV pool."""
from repro_torch.serving.api import (Request, RequestState, StepOutput,
                                     UnsupportedCacheLayout)
from repro_torch.serving.core import EngineCore
from repro_torch.serving.paged import PagedKVCache
from repro_torch.serving.sampling import (InvalidRequest, SamplingParams,
                                          greedy_rows, stop_hit, stop_holdback,
                                          validate_stop_tokens)
from repro_torch.serving.scheduler import (LanePlan, RaggedBatch,
                                           RunningRequest, Scheduler,
                                           default_token_buckets)

__all__ = ["EngineCore", "Request", "RequestState", "StepOutput",
           "UnsupportedCacheLayout", "PagedKVCache", "InvalidRequest",
           "SamplingParams", "greedy_rows", "stop_hit", "stop_holdback",
           "validate_stop_tokens", "LanePlan", "RaggedBatch",
           "RunningRequest", "Scheduler", "default_token_buckets"]
