"""Serving for the port: paged-KV engine with per-bucket prefill graphs,
continuous-batching scheduler and threaded server, the prefill→decode KV
handoff, draft-verify speculative decoding, weight hot-swap, the
checkpoint follower, tensor-parallel serving on a mesh of processes
(``mesh``: the leader and its followers), and the ``ReplicaSupervisor``
that restarts, replays and autoscales replicas (``supervisor``)
(counterparts of paddle_tpu/serving/)."""
from . import sampling  # noqa: F401
from .block_pool import BlockPool, PagePoolExhausted, RadixPrefixCache
from .engine import (FatalEngineError, GenerationEngine, StaleHandoffError,
                     WeightSwapError)
from .scheduler import (ContinuousBatchScheduler, GenerationRequest,
                        QueueFullError, RequestStatus)
from .server import CheckpointFollower, GenerationServer
from .spec_decode import DraftVerifyEngine
from .supervisor import ReplicaSupervisor

__all__ = ["BlockPool", "PagePoolExhausted", "RadixPrefixCache",
           "GenerationEngine", "WeightSwapError", "FatalEngineError",
           "StaleHandoffError", "ContinuousBatchScheduler",
           "GenerationRequest", "QueueFullError", "RequestStatus",
           "GenerationServer", "CheckpointFollower", "DraftVerifyEngine",
           "ReplicaSupervisor", "sampling"]
