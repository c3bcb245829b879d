"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Every Pallas kernel on the port's path is a CUDA C++ kernel in ``csrc/``
(built with nvcc for sm_90a at first use, bound with ctypes). Each wrapper
launches its kernel for CUDA tensors and takes the plain version for CPU
tensors only. The adapters below have the signatures the models and the
engine accept, like ``sentio_tpu/kernels/__init__.py``'s.
"""

from __future__ import annotations

import torch

from sentio_tpu_torch.kernels.flash_attention import KERNEL as FLASH_KERNEL
from sentio_tpu_torch.kernels.flash_attention import flash_attention
from sentio_tpu_torch.kernels.paged_attention import KERNEL as PAGED_KERNEL
from sentio_tpu_torch.kernels.paged_attention import KERNEL_QUANT as PAGED_QUANT_KERNEL
from sentio_tpu_torch.kernels.paged_attention import (
    QuantPages,
    paged_attention,
    paged_attention_quant,
)

__all__ = [
    "flash_attention", "paged_attention", "paged_attention_quant", "flash_attn_fn",
    "encoder_attn_fn", "default_attn_fn", "paged_attn_impl", "KERNELS", "FLASH_KERNEL", "PAGED_KERNEL", "PAGED_QUANT_KERNEL",
]

KERNELS = (PAGED_KERNEL, PAGED_QUANT_KERNEL, FLASH_KERNEL)


def flash_attn_fn(q, k, v, kv_lens=None):
    """Causal adapter for ``llama_forward(attn_fn=...)``: query i attends
    keys 0..i. The keys may run past the queries (a prefill over a cache
    window: S >= T); no query attends them, and the kernel reads none.
    Inputs are made contiguous (a no-op on the main path): with one kv
    head, ``repeat_kv`` returns a stride-0 view."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), kv_lens,
                           causal=True)


def default_attn_fn(device):
    """The prefill attention for ``device``, as JAX's ``default_attn_fn``
    picks it for the backend: the causal flash kernel on the card, None
    (the model's plain masked attention) on the CPU."""
    return flash_attn_fn if torch.device(device).type == "cuda" else None


def encoder_attn_fn(q, k, v, kv_lens=None):
    """Bidirectional adapter for encoder forwards: right-padded keys are
    masked by ``kv_lens``, no causal constraint."""
    return flash_attention(q, k, v, kv_lens, causal=False)


def paged_attn_impl(q, k_pages_l, v_pages_l, page_table, lens, n_rep):
    """Adapter with the ``paged_decode_forward(attn_impl=...)`` signature:
    (q [B,1,H,D], one layer's k/v pages, table, lens, n_rep) → [B,1,H,D].

    Routes on the pool's representation, as ``make_paged_attn_impl`` does:
    bf16 pages ``[P,page,Hkv,D]`` to the bf16 kernel, :class:`QuantPages`
    (the ``kv_quant="int8"`` pool) to the int8 kernel."""
    q = q[:, 0].contiguous()
    if isinstance(k_pages_l, QuantPages):
        out = paged_attention_quant(q, k_pages_l.q, k_pages_l.s, v_pages_l.q, v_pages_l.s,
                                    page_table, lens)
    else:
        out = paged_attention(q, k_pages_l, v_pages_l, page_table, lens)
    return out[:, None]
