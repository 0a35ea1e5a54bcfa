"""Serving for the port: paged-KV engine, continuous-batching scheduler and
threaded server, and draft-verify speculative decoding (counterparts of
paddle_tpu/serving/)."""
from .block_pool import BlockPool, PagePoolExhausted, RadixPrefixCache
from .engine import GenerationEngine
from .scheduler import (ContinuousBatchScheduler, GenerationRequest,
                        QueueFullError, RequestStatus)
from .server import GenerationServer
from .spec_decode import DraftVerifyEngine

__all__ = ["BlockPool", "PagePoolExhausted", "RadixPrefixCache",
           "GenerationEngine", "ContinuousBatchScheduler",
           "GenerationRequest", "QueueFullError", "RequestStatus",
           "GenerationServer", "DraftVerifyEngine"]
