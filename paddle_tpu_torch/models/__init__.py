"""Model families of the port: GPT, and the encoders BERT and ERNIE."""
from .bert import (BertConfig, BertForPretraining,
                   BertForSequenceClassification, BertModel,
                   BertPretrainingCriterion, bert_base, bert_tiny)
from .ernie import (ErnieConfig, ErnieForSequenceClassification, ErnieModel,
                    build_static_inference_program, ernie_3p0_medium,
                    ernie_tiny)
from .gpt import (GPTConfig, GPTForPretraining, GPTModel,
                  GPTPretrainingCriterion)

__all__ = ["GPTConfig", "GPTModel", "GPTForPretraining",
           "GPTPretrainingCriterion", "BertConfig", "BertModel",
           "BertForPretraining", "BertPretrainingCriterion",
           "BertForSequenceClassification", "bert_base", "bert_tiny",
           "ErnieConfig", "ErnieModel", "ErnieForSequenceClassification",
           "ernie_3p0_medium", "ernie_tiny",
           "build_static_inference_program"]
