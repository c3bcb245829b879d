"""Paged decode attention: the CUDA kernel's wrapper and its plain version.

Replaces ``sentio_tpu/kernels/paged_attention.py::_paged_kernel`` (bf16
pages; the int8 variant is not ported yet). The kernel is
``csrc/paged_attention.cu``: grid (B, Hkv), one block per (row, kv head)
walking the row's page table with an fp32 online softmax, each page's K/V
rows staged in shared memory; see the source for its geometry and what
bounds it.

:func:`paged_attention` launches the kernel for CUDA tensors and runs
:func:`paged_attention_plain` only for CPU tensors. There is no fallback
from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sentio_tpu_torch.kernels._build import CudaKernel, ptr, stream_of

__all__ = ["paged_attention", "paged_attention_plain", "KERNEL"]

NEG_INF = float(np.finfo(np.float32).min)

KERNEL = CudaKernel(
    "paged_attention", "paged_attention.cu", "paged_attention_bf16",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p],
)


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, page_table: torch.Tensor,
                          lens: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in float32.

    q [B, H, D]; k/v_pages [P, page, Hkv, D]; page_table [B, NB]; lens [B]
    (index of the current token) → [B, H, D] in q's dtype. Gathers each
    row's pages, masks key positions > lens (and zeroes them, so a poisoned
    page past a row's length cannot leak, as the kernel never reads it),
    softmax in fp32, and 0 for a row with l == 0."""
    b, h, d = q.shape
    _, page, hkv, _ = k_pages.shape
    nb = page_table.shape[1]
    rep = h // hkv
    table = page_table.long()
    window = nb * page
    valid = (torch.arange(window, device=q.device)[None, :]
             <= lens.long()[:, None])  # [B, S]
    vmask = valid[:, :, None, None]
    kc = torch.where(vmask, k_pages[table].reshape(b, window, hkv, d).float(), 0.0)
    vc = torch.where(vmask, v_pages[table].reshape(b, window, hkv, d).float(), 0.0)
    qf = q.float().reshape(b, hkv, rep, d)
    s = torch.einsum("bgrd,bsgd->bgrs", qf, kc) / float(np.sqrt(d))
    keep = valid[:, None, None, :]
    s = torch.where(keep, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bgrs,bsgd->bgrd", p, vc) / torch.where(l == 0, 1.0, l)
    return out.reshape(b, h, d).to(q.dtype)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                    page_table: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Decode attention over one layer's page pool → [B, H, D].

    CUDA tensors launch the hand-written kernel (bf16 q and pages, int32
    table and lens, contiguous); CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, page_table, lens)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    b, h, d = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"k/v pages must be [P, page, Hkv, D], got "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    num_pages, page, hkv, dk = k_pages.shape
    if dk != d or h % hkv or h // hkv > 8 or d % 8 or d > 256:
        raise ValueError(f"unsupported heads/dims: H={h} Hkv={hkv} D={d}")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_attention: page pools must be 16-byte aligned")
    if page_table.dim() != 2 or page_table.shape[0] != b or lens.shape != (b,):
        raise ValueError("page_table must be [B, NB] and lens [B]")
    for name, t, dtype in (("q", q, torch.bfloat16), ("k_pages", k_pages, torch.bfloat16),
                           ("v_pages", v_pages, torch.bfloat16),
                           ("page_table", page_table, torch.int32),
                           ("lens", lens, torch.int32)):
        if t.dtype != dtype or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be a contiguous "
                             f"{dtype} tensor on {q.device}")
    out = torch.empty_like(q)
    KERNEL.launch(
        ptr(q), ptr(k_pages), ptr(v_pages), ptr(page_table), ptr(lens), ptr(out),
        b, h, hkv, d, page, page_table.shape[1], num_pages,
        ctypes.c_float(1.0 / float(np.sqrt(d))), stream_of(q),
    )
    return out
