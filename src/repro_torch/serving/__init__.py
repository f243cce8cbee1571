"""Serving of the port: the rectangular and the continuous-batching
engine."""
from repro_torch.serving.engine import (ContinuousBatchingEngine,  # noqa: F401
                                        GenerationResult, ServeEngine)
from repro_torch.serving.scheduler import (Request, RequestOutput,  # noqa: F401
                                           StreamEvent, poisson_trace)
