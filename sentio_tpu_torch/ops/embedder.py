"""Bi-encoder embedder on the card — the device forward of
``sentio_tpu/ops/embedder.py::TpuEmbedder`` in PyTorch.

Texts are tokenized host-side, padded to the same sequence and batch
buckets as the JAX embedder, run through the encoder with the flash kernel
as its attention, and mean-pooled into L2-normalized vectors. The JAX
service wrapper's LFU cache and cross-thread coalescer are host services
outside this slice.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from sentio_tpu_torch import resolve_device
from sentio_tpu_torch.config import EmbedderConfig
from sentio_tpu_torch.kernels import encoder_attn_fn
from sentio_tpu_torch.models.tokenizer import ByteTokenizer, batch_encode
from sentio_tpu_torch.models.transformer import (
    EncoderConfig,
    encoder_forward,
    init_encoder,
    mean_pool,
)
from sentio_tpu_torch.parallel.batcher import bucket_size
from sentio_tpu_torch.runtime.weights import load_encoder, refuse_tokenizer


class TorchEmbedder:
    BUCKETS = (16, 32, 64, 128, 256, 512)
    BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)

    def __init__(self, config: Optional[EmbedderConfig] = None, params: Optional[dict] = None,
                 model_config: Optional[EncoderConfig] = None,
                 device=None, generator: Optional[torch.Generator] = None) -> None:
        self.config = config or EmbedderConfig()
        self.device = resolve_device(device)
        refuse_tokenizer("EMBEDDER_TOKENIZER", self.config.tokenizer_path)
        if params is None and self.config.checkpoint_path:
            params, model_config = load_encoder(self.config.checkpoint_path,
                                                device=self.device)
        self.model_config = model_config or (
            EncoderConfig.tiny() if self.config.model_preset == "tiny" else EncoderConfig.base()
        )
        self.tokenizer = ByteTokenizer(self.model_config.vocab_size)
        if params is None:
            if generator is None:
                generator = torch.Generator(device=self.device)
                generator.manual_seed(0)
            params = init_encoder(self.model_config, generator, self.device)
        self.params = params

    @property
    def dimension(self) -> int:
        return self.model_config.dim

    def embed_many(self, texts: Sequence[str]) -> np.ndarray:
        """[N, D] float32 host array, in batches of ``config.batch_size``."""
        out = np.zeros((len(texts), self.dimension), np.float32)
        step = self.config.batch_size
        for start in range(0, len(texts), step):
            out[start : start + step] = self.embed_tensor(texts[start : start + step]).cpu().numpy()
        return out

    def embed_tensor(self, texts: Sequence[str]) -> torch.Tensor:
        """[n, D] float32 on the device, no host copy (the dense retrieval
        leg feeds it straight to the index)."""
        ids, mask = batch_encode(
            self.tokenizer, list(texts),
            max_len=min(self.config.max_tokens, self.model_config.max_len),
        )
        # pad sequence AND batch to buckets, as the JAX embedder does
        n = ids.shape[0]
        width = bucket_size(ids.shape[1], self.BUCKETS)
        rows = bucket_size(n, self.BATCH_BUCKETS)
        ids = np.pad(ids, ((0, rows - n), (0, width - ids.shape[1])),
                     constant_values=self.tokenizer.pad_id)
        mask = np.pad(mask, ((0, rows - n), (0, width - mask.shape[1])))
        ids_t = torch.as_tensor(ids, device=self.device)
        mask_t = torch.as_tensor(mask, device=self.device)
        with torch.inference_mode():
            hidden = encoder_forward(self.params, self.model_config, ids_t, mask_t,
                                     attn_fn=encoder_attn_fn)
            return mean_pool(hidden, mask_t)[:n]
