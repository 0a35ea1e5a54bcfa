"""``meta_parallel`` (counterpart of
paddle_tpu/distributed/meta_parallel): the tensor-parallel layers, their
primitives and the named random streams. The pipeline layers wait for
ROADMAP queue 1 item 7."""
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,  # noqa: F401
                        RowParallelLinear, VocabParallelEmbedding)
from .random_ctrl import (RNGStatesTracker, get_rng_state_tracker,  # noqa: F401
                          model_parallel_random_seed)
