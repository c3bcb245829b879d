"""Cross-encoder relevance scorer in PyTorch — the counterpart of
``sentio_tpu/models/cross_encoder.py``: ``[CLS] q [SEP] d [SEP]`` pairs
through the shared bidirectional encoder, the [CLS] state into a scalar
relevance head.
"""

from __future__ import annotations

from typing import Optional

import torch

from sentio_tpu_torch.models import layers as L
from sentio_tpu_torch.parallel.sharding import TPShards
from sentio_tpu_torch.models.transformer import (
    EncoderConfig,
    cls_pool,
    dense_init,
    encoder_forward,
    init_encoder,
)

Tensor = torch.Tensor


def init_cross_encoder(cfg: EncoderConfig, generator: torch.Generator, device,
                       dtype: Optional[torch.dtype] = None) -> dict:
    dt = dtype or cfg.torch_dtype
    return {
        "encoder": init_encoder(cfg, generator, device, dt),
        "head": dense_init(cfg.dim, 1, generator, device, dt),
    }


def cross_encoder_scores(params: dict, cfg: EncoderConfig, ids: Tensor,
                         mask: Tensor, type_ids: Tensor, attn_fn=None) -> Tensor:
    """[B, T] pair encodings → [B] float32 relevance scores. An optional
    ``pooler`` stage (dense + tanh over [CLS]) runs between pooling and the
    scalar head when the parameters carry one."""
    if isinstance(params, TPShards):  # the head and pooler replicate
        encoder = TPShards([tree["encoder"] for tree in params], params.devices)
        params = params[0]
    else:
        encoder = params["encoder"]
    hidden = encoder_forward(encoder, cfg, ids, mask, type_ids, attn_fn=attn_fn)
    pooled = cls_pool(hidden)
    if "pooler" in params:
        pooled = torch.tanh(L.dense(params["pooler"], pooled, torch.float32))
    scores = L.dense(params["head"], pooled, torch.float32)
    return scores[:, 0].float()
