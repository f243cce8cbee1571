"""Continuous-batching serving of the port."""
from repro_torch.serving.engine import ContinuousBatchingEngine  # noqa: F401
from repro_torch.serving.scheduler import (Request, RequestOutput,  # noqa: F401
                                           StreamEvent, poisson_trace)
