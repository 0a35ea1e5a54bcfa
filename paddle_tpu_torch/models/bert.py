"""BERT (counterpart of paddle_tpu/models/bert.py): embeddings, the
Paddle-API ``TransformerEncoder`` (post-norm, exact GELU), the pooler, and
the pretraining and sequence-classification heads.

Submodule names are the reference's one to one, so ``convert`` maps the
weights by name. The LM head's decoder weight is the word embeddings'
weight itself: one parameter, stepped once, listed once in
``state_dict()`` (as ``bert.embeddings.word_embeddings.weight``, the
reference's only name for it) — the head holds it outside its own
parameters.

A model builds on the meta device and then initialises every parameter
from ``generator`` on its device (the reference's initializers:
TruncatedNormal(0.02) embeddings, XavierUniform Linears, zero biases, unit
LayerNorms), each layer its own draw. Heads built around it
(:meth:`BertModel.attach_head`) are initialised from the same generator.

Dropout: each training forward draws one key from ``generator`` (else
torch's default generator on the model's device) and every dropout layer
of the model and its heads hashes it with its own site
(``nn.layer.common.DropoutKeys``): the masks are the same eagerly and
under ``TrainStep``'s CUDA graph, which registers ``generator``.

The attention route is picked once (``attn_kernel``, see
``ops.flash_attention.select_flash_kernel``): on the "cuda" route a
forward without a padding mask at a length the kernels take runs K1 per
layer, non-causal (K2 and K3 in the backward); a padding mask takes the
plain route and records a ``kernel_fallback`` event.
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from ..nn import functional as F
from ..nn.initializer import ParamAttr, TruncatedNormal
from ..nn.layer.common import Dropout, DropoutKeys, Embedding, Linear
from ..nn.layer.layers import ParamLayer, init_parameters
from ..nn.layer.norm import LayerNorm
from ..nn.layer.transformer import (MultiHeadAttention, TransformerEncoder,
                                    TransformerEncoderLayer)
from ..ops.flash_attention import select_flash_kernel

__all__ = ["BertConfig", "BertModel", "BertForPretraining",
           "BertPretrainingCriterion", "BertForSequenceClassification",
           "BertLMPredictionHead", "bert_base", "bert_tiny"]


class BertConfig:
    PRESETS = {
        "bert-tiny": dict(num_hidden_layers=2, num_attention_heads=2,
                          hidden_size=128, intermediate_size=512),
        "bert-base": dict(num_hidden_layers=12, num_attention_heads=12,
                          hidden_size=768, intermediate_size=3072),
        "bert-large": dict(num_hidden_layers=24, num_attention_heads=16,
                           hidden_size=1024, intermediate_size=4096),
    }

    def __init__(self, vocab_size=30522, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, hidden_act="gelu",
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 max_position_embeddings=512, type_vocab_size=2,
                 initializer_range=0.02, pad_token_id=0):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.hidden_act = hidden_act
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.initializer_range = initializer_range
        self.pad_token_id = pad_token_id

    @classmethod
    def preset(cls, name, **overrides):
        cfg = dict(cls.PRESETS[name])
        cfg.update(overrides)
        return cls(**cfg)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        init = ParamAttr(initializer=TruncatedNormal(
            std=cfg.initializer_range))
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size,
                                         weight_attr=init,
                                         padding_idx=cfg.pad_token_id)
        self.position_embeddings = Embedding(cfg.max_position_embeddings,
                                             cfg.hidden_size,
                                             weight_attr=init)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size,
                                               cfg.hidden_size,
                                               weight_attr=init)
        self.layer_norm = LayerNorm(cfg.hidden_size, epsilon=1e-12)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device).unsqueeze(0)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(position_ids)
               + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class BertPooler(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, hidden):
        return torch.tanh(self.dense(hidden[:, 0]))


class BertModel(nn.Module):
    """Embeddings, ``TransformerEncoder`` and pooler; returns ``(sequence
    output [B, T, D], pooled [B, D])``. ``device=None`` builds on the
    current CUDA device and raises without one; ``device="cpu"`` builds
    on the CPU. See the module's docstring for ``generator`` and
    ``attn_kernel``."""

    def __init__(self, cfg: BertConfig, device=None, generator=None,
                 attn_kernel=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.attn_kernel = select_flash_kernel(
            attn_kernel, device=dev,
            head_dim=cfg.hidden_size // cfg.num_attention_heads,
            dtype=torch.get_default_dtype())
        self.generator = generator
        self.dropout_keys = DropoutKeys(generator)
        with torch.device("meta"):
            self.embeddings = BertEmbeddings(cfg)
            layer = TransformerEncoderLayer(
                cfg.hidden_size, cfg.num_attention_heads,
                cfg.intermediate_size, dropout=cfg.hidden_dropout_prob,
                activation=cfg.hidden_act,
                attn_dropout=cfg.attention_probs_dropout_prob,
                act_dropout=0.0)
            self.encoder = TransformerEncoder(layer, cfg.num_hidden_layers)
            self.pooler = BertPooler(cfg)
        self._adopt(self, dev, torch.get_default_dtype())

    @property
    def device(self):
        return self.embeddings.word_embeddings.weight.device

    def _adopt(self, module, device, dtype):
        module.to_empty(device=device)
        init_parameters(module, self.generator)
        module.to(dtype)
        self.dropout_keys.attach(module)
        for mod in module.modules():
            if isinstance(mod, MultiHeadAttention):
                mod.kernel = self.attn_kernel

    def attach_head(self, head):
        """``head`` (built on the meta device) moved to this model's device
        and dtype, its parameters initialised from this model's generator,
        its dropout layers drawing from this model's key, its attention on
        this model's route. Returns ``head``."""
        self._adopt(head, self.device,
                    self.embeddings.word_embeddings.weight.dtype)
        return head

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        """``attention_mask``: ``[B, T]`` with 1 (or True) for the tokens to
        attend to becomes a float32 additive ``[B, 1, 1, T]`` mask of 0 and
        -1e9, as the reference's; any other mask goes to the encoder as it
        is."""
        if attention_mask is not None and attention_mask.dim() == 2:
            attention_mask = ((1.0 - attention_mask.float()) * -1e9)[
                :, None, None, :]
        if self.training:
            self.dropout_keys.draw(input_ids.device)
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        seq = self.encoder(x, attention_mask)
        return seq, self.pooler(seq)


class BertLMPredictionHead(ParamLayer, nn.Module):
    """``layer_norm(act(transform(h))) @ W^T + decoder_bias`` with ``W``
    the word embeddings' weight, tied: held outside this module's
    parameters, so it is one parameter of the model."""

    def __init__(self, cfg: BertConfig, embedding_weights):
        nn.Module.__init__(self)
        self.create_parameter("decoder_bias", [cfg.vocab_size],
                              is_bias=True)
        self.transform = Linear(cfg.hidden_size, cfg.hidden_size)
        self.layer_norm = LayerNorm(cfg.hidden_size, epsilon=1e-12)
        self._tied = (embedding_weights,)
        self.act = cfg.hidden_act

    @property
    def decoder_weight(self):
        return self._tied[0]

    def forward(self, hidden):
        h = self.layer_norm(getattr(F, self.act)(self.transform(hidden)))
        return torch.nn.functional.linear(h, self.decoder_weight,
                                          self.decoder_bias)


class BertForPretraining(nn.Module):
    """MLM and NSP heads: returns ``(prediction_scores [B, T, V],
    seq_relationship_score [B, 2])``."""

    def __init__(self, bert: BertModel):
        super().__init__()
        self.bert = bert
        cfg = bert.cfg
        with torch.device("meta"):
            cls = BertLMPredictionHead(
                cfg, bert.embeddings.word_embeddings.weight)
            nsp = Linear(cfg.hidden_size, 2)
        self.cls = bert.attach_head(cls)
        self.nsp = bert.attach_head(nsp)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, position_ids,
                                attention_mask)
        return self.cls(seq), self.nsp(pooled)


class BertPretrainingCriterion(nn.Module):
    """Mean MLM cross-entropy over the labels that are not -100, plus the
    mean NSP cross-entropy. The reference averages over every label, -100
    included (its cross_entropy ignores only a non-negative
    ``ignore_index``; ROADMAP queue 3)."""

    def __init__(self, vocab_size):
        super().__init__()
        self.vocab_size = vocab_size

    def forward(self, prediction_scores, seq_relationship_score,
                masked_lm_labels, next_sentence_labels, masked_lm_scale=1.0):
        mlm = F.cross_entropy(
            prediction_scores.reshape(-1, self.vocab_size),
            masked_lm_labels.reshape(-1), reduction="mean",
            ignore_index=-100)
        nsp = F.cross_entropy(seq_relationship_score,
                              next_sentence_labels.reshape(-1))
        return mlm + nsp


class BertForSequenceClassification(nn.Module):
    def __init__(self, bert: BertModel, num_classes=2, dropout=None):
        super().__init__()
        self.bert = bert
        with torch.device("meta"):
            drop = Dropout(dropout if dropout is not None
                           else bert.cfg.hidden_dropout_prob)
            classifier = Linear(bert.cfg.hidden_size, num_classes)
        self.dropout = bert.attach_head(drop)
        self.classifier = bert.attach_head(classifier)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, position_ids,
                              attention_mask)
        return self.classifier(self.dropout(pooled))


def bert_base(device=None, generator=None, attn_kernel=None, **kw):
    """``BertModel`` of the bert-base preset (``kw`` overrides its
    fields)."""
    return BertModel(BertConfig.preset("bert-base", **kw), device=device,
                     generator=generator, attn_kernel=attn_kernel)


def bert_tiny(device=None, generator=None, attn_kernel=None, **kw):
    return BertModel(BertConfig.preset("bert-tiny", **kw), device=device,
                     generator=generator, attn_kernel=attn_kernel)
