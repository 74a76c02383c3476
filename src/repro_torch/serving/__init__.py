"""Serving: request batching + the async pipelined online PPR service."""

from repro_torch.serving.cache import (  # noqa: F401
    AnswerCache, CacheConfig, canonicalize_seed_set,
)
from repro_torch.serving.engine import (  # noqa: F401
    Answer, PPRService, ServiceConfig,
)
from repro_torch.serving.loadgen import (  # noqa: F401
    WorkItem, run_closed_loop, run_open_loop, zipf_seed_workload,
)
from repro_torch.serving.pipeline import (  # noqa: F401
    PipelineConfig, ServingPipeline,
)
