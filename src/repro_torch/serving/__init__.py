"""Request-level serving for the port: EngineCore over a paged KV pool (the
ragged stream, or the padded-block oracle) and its deprecated
PagedServingEngine shim, the slot-contiguous ServingEngine for the cache
layouts the pool rejects, the in-step sampler, and the asyncio front
door."""
from repro_torch.serving.api import (Request, RequestState, StepOutput,
                                     UnsupportedCacheLayout)
from repro_torch.serving.core import EngineCore, greedy_token, greedy_tokens
from repro_torch.serving.engine import PagedServingEngine, ServingEngine
from repro_torch.serving.metrics import (Counter, Gauge, Histogram,
                                         MetricsRegistry, start_metrics_server,
                                         write_metrics_json)
from repro_torch.serving.paged import PagedKVCache
from repro_torch.serving.prefix_cache import PrefixHit, RadixPrefixCache
from repro_torch.serving.sampling import (InvalidRequest, SamplingParams,
                                          greedy_rows, sample_in_step,
                                          sample_row, sample_rows, stop_hit,
                                          stop_holdback, validate_stop_tokens)
from repro_torch.serving.scheduler import (LanePlan, RaggedBatch,
                                           RunningRequest, Scheduler,
                                           default_token_buckets)
from repro_torch.serving.server import (AsyncLMServer, ServerClosed,
                                        ServerOverloaded)
from repro_torch.serving.spec import NGramProposer
from repro_torch.serving.tracing import (RequestSpan, RequestTracer,
                                         ServingObservability, SpanEvent,
                                         StepTraceRing)

__all__ = ["AsyncLMServer", "Counter", "EngineCore", "Gauge", "Histogram",
           "InvalidRequest", "LanePlan", "MetricsRegistry", "NGramProposer",
           "PagedKVCache", "PagedServingEngine", "PrefixHit",
           "RadixPrefixCache", "RaggedBatch",
           "Request", "RequestSpan", "RequestState", "RequestTracer",
           "RunningRequest", "SamplingParams", "Scheduler", "ServerClosed",
           "ServerOverloaded", "ServingEngine", "ServingObservability",
           "SpanEvent",
           "StepOutput", "StepTraceRing", "UnsupportedCacheLayout",
           "default_token_buckets", "greedy_rows", "greedy_token",
           "greedy_tokens",
           "sample_in_step",
           "sample_row", "sample_rows", "start_metrics_server", "stop_hit",
           "stop_holdback", "validate_stop_tokens", "write_metrics_json"]
