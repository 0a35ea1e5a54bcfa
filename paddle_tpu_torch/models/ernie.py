"""ERNIE-3.0-style encoder (counterpart of paddle_tpu/models/ernie.py): a
BERT encoder with its own presets and a sequence-classification head, and
``build_static_inference_program``, which records the model into a static
Program for ``static.Executor`` (BASELINE config 5: on the card the
Executor runs it as one CUDA graph).
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn.layer.common import Dropout, Linear
from .bert import BertConfig, BertModel

__all__ = ["ErnieConfig", "ErnieModel", "ErnieForSequenceClassification",
           "ernie_3p0_medium", "ernie_tiny",
           "build_static_inference_program"]


class ErnieConfig(BertConfig):
    PRESETS = {
        "ernie-tiny": dict(num_hidden_layers=2, num_attention_heads=2,
                           hidden_size=128, intermediate_size=512),
        "ernie-3.0-medium": dict(num_hidden_layers=6, num_attention_heads=12,
                                 hidden_size=768, intermediate_size=3072),
        "ernie-3.0-base": dict(num_hidden_layers=12, num_attention_heads=12,
                               hidden_size=768, intermediate_size=3072),
        "ernie-3.0-xbase": dict(num_hidden_layers=20, num_attention_heads=16,
                                hidden_size=1024, intermediate_size=4096),
    }


class ErnieModel(BertModel):
    """``BertModel`` over an ``ErnieConfig``."""


class ErnieForSequenceClassification(nn.Module):
    """``classifier(dropout(pooled))`` of an ErnieModel; the forward takes
    no attention mask, as the reference's."""

    def __init__(self, ernie: ErnieModel, num_classes=2, dropout=None):
        super().__init__()
        self.ernie = ernie
        with torch.device("meta"):
            drop = Dropout(dropout if dropout is not None
                           else ernie.cfg.hidden_dropout_prob)
            classifier = Linear(ernie.cfg.hidden_size, num_classes)
        self.dropout = ernie.attach_head(drop)
        self.classifier = ernie.attach_head(classifier)

    def forward(self, input_ids, token_type_ids=None):
        _, pooled = self.ernie(input_ids, token_type_ids)
        return self.classifier(self.dropout(pooled))


def ernie_3p0_medium(device=None, generator=None, attn_kernel=None, **kw):
    """``ErnieModel`` of the ernie-3.0-medium preset (6 layers, 12 heads,
    hidden 768)."""
    return ErnieModel(ErnieConfig.preset("ernie-3.0-medium", **kw),
                      device=device, generator=generator,
                      attn_kernel=attn_kernel)


def ernie_tiny(device=None, generator=None, attn_kernel=None, **kw):
    return ErnieModel(ErnieConfig.preset("ernie-tiny", **kw), device=device,
                      generator=generator, attn_kernel=attn_kernel)


def build_static_inference_program(model, seq_len=128, batch=None):
    """Record ``model`` (in eval mode) into a static Program for
    ``static.Executor`` inference (BASELINE config 5) from one int64 feed
    ``input_ids`` ``[batch or None, seq_len]``. Returns ``(program,
    ["input_ids"], fetch)``: the logits of a classifier, the pooled output
    of an ``ErnieModel``. Static mode is left as it was found."""
    from .. import static
    from ..framework import disable_static, enable_static, in_dynamic_mode

    was_dynamic = in_dynamic_mode()
    enable_static()
    try:
        prog = static.Program()
        with static.program_guard(prog):
            input_ids = static.data("input_ids", [batch or -1, seq_len],
                                    "int64")
            model.eval()
            out = model(input_ids)
            fetch = out[1] if isinstance(out, tuple) else out
        return prog, ["input_ids"], fetch
    finally:
        if was_dynamic:
            disable_static()
