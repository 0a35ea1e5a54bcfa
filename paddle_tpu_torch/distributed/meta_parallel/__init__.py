"""``meta_parallel`` (counterpart of
paddle_tpu/distributed/meta_parallel): the tensor-parallel layers, their
primitives, the named random streams, and the pipeline layer
descriptions (``pp_layers``)."""
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,  # noqa: F401
                        RowParallelLinear, VocabParallelEmbedding)
from .random_ctrl import (RNGStatesTracker, get_rng_state_tracker,  # noqa: F401
                          model_parallel_random_seed)
from .pp_layers import (LayerDesc, PipelineLayer,  # noqa: F401
                        PipelineStageError, SharedLayerDesc)
