"""Serving for the port: paged-KV engine, continuous-batching scheduler and
threaded server, draft-verify speculative decoding, weight hot-swap and the
checkpoint follower (counterparts of paddle_tpu/serving/)."""
from .block_pool import BlockPool, PagePoolExhausted, RadixPrefixCache
from .engine import FatalEngineError, GenerationEngine, WeightSwapError
from .scheduler import (ContinuousBatchScheduler, GenerationRequest,
                        QueueFullError, RequestStatus)
from .server import CheckpointFollower, GenerationServer
from .spec_decode import DraftVerifyEngine

__all__ = ["BlockPool", "PagePoolExhausted", "RadixPrefixCache",
           "GenerationEngine", "WeightSwapError", "FatalEngineError",
           "ContinuousBatchScheduler", "GenerationRequest", "QueueFullError",
           "RequestStatus", "GenerationServer", "CheckpointFollower",
           "DraftVerifyEngine"]
