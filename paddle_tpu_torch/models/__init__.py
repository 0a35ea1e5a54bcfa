"""Model families of the port (GPT so far)."""
from .gpt import (GPTConfig, GPTForPretraining, GPTModel,
                  GPTPretrainingCriterion)

__all__ = ["GPTConfig", "GPTModel", "GPTForPretraining",
           "GPTPretrainingCriterion"]
