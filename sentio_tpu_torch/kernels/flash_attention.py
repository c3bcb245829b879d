"""Blockwise attention: the CUDA kernel's wrapper and its plain version.

Replaces ``sentio_tpu/kernels/flash_attention.py::_flash_kernel``, both
forms: non-causal (the embedder and the cross-encoder) and causal. The
kernel is ``csrc/flash_attention.cu``: one block per (batch-head, 128-row
query tile), two warpgroups of 64 rows each looping over key tiles with
both products on the tensor cores (wgmma, bf16 in, fp32 sums) and an fp32
online softmax in registers; see the source for its geometry and what
bounds it.

:func:`flash_attention` launches the kernel for CUDA tensors and runs
:func:`flash_attention_plain` only for CPU tensors. There is no fallback
from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from sentio_tpu_torch.kernels._build import CudaKernel, ptr, stream_of

__all__ = ["flash_attention", "flash_attention_plain", "KERNEL"]

NEG_INF = float(np.finfo(np.float32).min)
HEAD_DIMS = (16, 32, 64, 128)

KERNEL = CudaKernel(
    "flash_attention", "flash_attention.cu", "flash_attention_bf16",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
)


def _lens_or_full(kv_lens: Optional[torch.Tensor], b: int, s: int,
                  device) -> torch.Tensor:
    if kv_lens is None:
        return torch.full((b,), s, dtype=torch.int32, device=device)
    return kv_lens


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_lens: Optional[torch.Tensor] = None, *,
                          causal: bool = True) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in float32.

    q [B, T, H, D], k/v [B, S, H, D] → [B, T, H, D] in q's dtype. Keys at
    positions >= kv_lens[b] are masked (and zeroed), ``causal`` also masks
    k_pos > q_pos (so no key at or past T is read when S > T), and a query
    row with no key left to attend is 0 — unlike ``layers.attention``,
    which averages every key for such a row."""
    b, t, h, d = q.shape
    s_len = k.shape[1]
    lens = _lens_or_full(kv_lens, b, s_len, q.device).long()
    if causal:
        lens = lens.clamp_max(t)
    k_pos = torch.arange(s_len, device=q.device)
    valid = (k_pos[None, :] < lens[:, None])[:, None, None, :]  # [B,1,1,S]
    if causal:
        q_pos = torch.arange(t, device=q.device)
        valid = valid & (k_pos[None, :] <= q_pos[:, None])[None, None]
    key_ok = (k_pos[None, :] < lens[:, None])[:, :, None, None]  # [B,S,1,1]
    kf = torch.where(key_ok, k.float(), 0.0)
    vf = torch.where(key_ok, v.float(), 0.0)
    sc = torch.einsum("bthd,bshd->bhts", q.float(), kf) / float(np.sqrt(d))
    sc = torch.where(valid, sc, NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(sc - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhts,bshd->bthd", p / torch.where(l == 0, 1.0, l), vf)
    return out.to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_lens: Optional[torch.Tensor] = None, *,
                    causal: bool = True) -> torch.Tensor:
    """q [B, T, H, D], k/v [B, S, H, D] (kv heads expanded) → [B, T, H, D].

    CUDA tensors launch the hand-written kernel (bf16, contiguous, 16-byte
    aligned, D in 16/32/64/128, int32 ``kv_lens``); CPU tensors take the
    plain version."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_lens, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, t, h, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"k/v must be [B, S, H, D] matching q {tuple(q.shape)}, "
                         f"got {tuple(k.shape)} / {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    lens = _lens_or_full(kv_lens, b, k.shape[1], q.device)
    if lens.shape != (b,):
        raise ValueError("kv_lens must be [B]")
    for name, x, dtype in (("q", q, torch.bfloat16), ("k", k, torch.bfloat16),
                           ("v", v, torch.bfloat16), ("kv_lens", lens, torch.int32)):
        if x.dtype != dtype or x.device != q.device or not x.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"{dtype} tensor on {q.device}")
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_attention: q, k and v must be 16-byte aligned")
    out = torch.empty_like(q)
    KERNEL.launch(
        ptr(q), ptr(k), ptr(v), ptr(lens), ptr(out),
        b, t, k.shape[1], h, d, ctypes.c_float(1.0 / float(np.sqrt(d))),
        int(bool(causal)), stream_of(q),
    )
    return out
