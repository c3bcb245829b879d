"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Every Pallas kernel on the port's path is a CUDA C++ kernel in ``csrc/``
(built with nvcc for sm_90a at first use, bound with ctypes). Each wrapper
launches its kernel for CUDA tensors and takes the plain version for CPU
tensors only. The adapters below have the signatures the models and the
engine accept, like ``sentio_tpu/kernels/__init__.py``'s.
"""

from __future__ import annotations

from sentio_tpu_torch.kernels.flash_attention import KERNEL as FLASH_KERNEL
from sentio_tpu_torch.kernels.flash_attention import flash_attention
from sentio_tpu_torch.kernels.paged_attention import KERNEL as PAGED_KERNEL
from sentio_tpu_torch.kernels.paged_attention import paged_attention

__all__ = [
    "flash_attention", "paged_attention", "encoder_attn_fn",
    "paged_attn_impl", "KERNELS", "FLASH_KERNEL", "PAGED_KERNEL",
]

KERNELS = (PAGED_KERNEL, FLASH_KERNEL)


def encoder_attn_fn(q, k, v, kv_lens=None):
    """Bidirectional adapter for encoder forwards: right-padded keys are
    masked by ``kv_lens``, no causal constraint."""
    return flash_attention(q, k, v, kv_lens, causal=False)


def paged_attn_impl(q, k_pages_l, v_pages_l, page_table, lens, n_rep):
    """Adapter with the ``paged_decode_forward(attn_impl=...)`` signature:
    (q [B,1,H,D], k/v pages [P,page,Hkv,D], table, lens, n_rep) → [B,1,H,D]."""
    return paged_attention(q[:, 0].contiguous(), k_pages_l, v_pages_l,
                           page_table, lens)[:, None]
