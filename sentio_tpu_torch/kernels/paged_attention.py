"""Paged decode attention: the CUDA kernels' wrappers and their plain
versions.

Replaces both variants of ``sentio_tpu/kernels/paged_attention.py``:

* ``_paged_kernel`` (bf16 pages) by ``csrc/paged_attention.cu``;
* ``_paged_kernel_quant`` (int8 pages with f16 per-vector scales, the
  ``KV_QUANT=int8`` pool) by ``csrc/paged_attention_quant.cu``.

Both kernels split each row's pages into spans (:data:`PAGES_PER_SPAN`
pages for the bf16 kernel, :data:`PAGES_PER_SPAN_QUANT` for the int8 one):
grid (B, Hkv, spans), each block an fp32 online softmax over its span's
pages with both products on the tensor cores, then a combine kernel
(launched by the same C entry point) merges a row's spans into bf16 out;
the wrapper allocates the partials' scratch. The int8 kernel takes the
codes into bf16 products and folds the scales as the TPU kernel does. See
the sources for their geometry and what bounds them.

:func:`paged_attention` and :func:`paged_attention_quant` launch their
kernels for CUDA tensors and run the plain versions only for CPU tensors.
There is no fallback from a kernel to its plain version.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from sentio_tpu_torch.kernels._build import CudaKernel, ptr, stream_of

__all__ = [
    "QuantPages", "paged_attention", "paged_attention_plain", "paged_attention_quant",
    "paged_attention_quant_plain", "span_kernel", "KERNEL", "KERNEL_QUANT",
    "PAGES_PER_SPAN", "PAGES_PER_SPAN_QUANT", "quant_occupancy",
]

NEG_INF = float(np.finfo(np.float32).min)
# consecutive pages of one row per block of the bf16 kernel, compiled into
# it; chosen by measuring 1, 2 and 4 on the card (chip_smoke.py's sweep,
# PERF.md): two pages a block were as fast as one at a chat's decode shape
# (one live row) and faster at a full serving batch, where four were
# slower at the chat's
PAGES_PER_SPAN = 2
# the same for the int8 kernel, by the same sweep (PERF.md): one page a
# block was ~5% faster at a chat's decode shape but ~18% slower at a full
# serving batch, four pages ~7% faster there and ~25% slower at the chat's
PAGES_PER_SPAN_QUANT = 2
PAGED_HEAD_DIMS = (32, 64, 128, 256)  # the kernels' tensor-core tiles


def span_kernel(pages_per_span: int, quant: bool = False) -> CudaKernel:
    """The bf16 (or, with ``quant``, the int8) kernel compiled with spans of
    ``pages_per_span`` pages (its own library). :data:`KERNEL` and
    :data:`KERNEL_QUANT` are the builds at :data:`PAGES_PER_SPAN` and
    :data:`PAGES_PER_SPAN_QUANT`; the others exist to time the choice."""
    name, source, symbol, n_ptrs, committed = (
        ("paged_attention_quant", "paged_attention_quant.cu", "paged_attention_int8", 9,
         PAGES_PER_SPAN_QUANT) if quant else
        ("paged_attention", "paged_attention.cu", "paged_attention_bf16", 7, PAGES_PER_SPAN))
    if pages_per_span != committed:
        name = f"{name}_span{pages_per_span}"
    return CudaKernel(
        name, source, symbol,
        [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p],
        defines=(f"SENTIO_PAGES_PER_SPAN={pages_per_span}",),
    )


KERNEL = span_kernel(PAGES_PER_SPAN)
KERNEL_QUANT = span_kernel(PAGES_PER_SPAN_QUANT, quant=True)


class QuantPages(NamedTuple):
    """An int8 page pool: codes ``q`` int8 ``[..., page, Hkv, D]`` and their
    per-vector absmax scales ``s`` f16 ``[..., page, Hkv]`` (the JAX
    package's ``{"q": ..., "s": ...}`` pytree)."""

    q: torch.Tensor
    s: torch.Tensor


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, page_table: torch.Tensor,
                          lens: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in float32.

    q [B, H, D]; k/v_pages [P, page, Hkv, D]; page_table [B, NB]; lens [B]
    (index of the current token) → [B, H, D] in q's dtype. Gathers each
    row's pages, masks key positions > lens (and zeroes them, so a poisoned
    page past a row's length cannot leak, as the kernel never reads it),
    softmax in fp32, and 0 for a row with l == 0."""
    b = q.shape[0]
    _, page, hkv, d = k_pages.shape
    window = page_table.shape[1] * page
    table = page_table.long()
    return _attend(q, k_pages[table].reshape(b, window, hkv, d),
                   v_pages[table].reshape(b, window, hkv, d), lens)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            lens: torch.Tensor) -> torch.Tensor:
    """q [B, H, D] over gathered windows k/v [B, S, Hkv, D], keys at
    positions <= lens; float32 softmax, 0 for a row with nothing to attend."""
    b, h, d = q.shape
    window, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    valid = (torch.arange(window, device=q.device)[None, :]
             <= lens.long()[:, None])  # [B, S]
    vmask = valid[:, :, None, None]
    kc = torch.where(vmask, k.float(), 0.0)
    vc = torch.where(vmask, v.float(), 0.0)
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

    CUDA tensors launch the hand-written kernel (bf16 q and pages, D in
    32/64/128/256, int32 table and lens, contiguous); CPU tensors take the
    plain version."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, page_table, lens)
    _check("paged_attention", q, k_pages, v_pages, page_table, lens,
           tensors=(("k_pages", k_pages, torch.bfloat16),
                    ("v_pages", v_pages, torch.bfloat16)))
    return _launch(KERNEL, q, k_pages, v_pages, page_table, lens)


def _launch(kernel: CudaKernel, q: torch.Tensor, *inputs: torch.Tensor) -> torch.Tensor:
    """Launch a build of a paged kernel (:func:`span_kernel`) on checked
    inputs, in its entry point's order: q, the pools (k_pages, v_pages for
    the bf16 kernel; k_q, k_s, v_q, v_s for the int8 one), page_table,
    lens. The partials go to fp32 scratch of [B, H, NB, D + 2]: room for
    spans of one page, so enough at any span size."""
    b, h, d = q.shape
    num_pages, page, hkv, _ = inputs[0].shape
    nb = inputs[-2].shape[1]
    out = torch.empty_like(q)
    scratch = torch.empty(b * h * nb * (d + 2), dtype=torch.float32, device=q.device)
    kernel.launch(
        ptr(q), *(ptr(x) for x in inputs), ptr(out), ptr(scratch),
        b, h, hkv, d, page, nb, num_pages,
        ctypes.c_float(1.0 / float(np.sqrt(d))), stream_of(q),
    )
    return out


def _check(fn: str, q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
           page_table: torch.Tensor, lens: torch.Tensor, tensors: tuple) -> None:
    """Raise ``ValueError`` unless the inputs are what a paged kernel takes:
    CUDA tensors, K/V payloads [P, page, Hkv, D] aligned to 16 bytes, at
    most 8 query heads per kv head, D one of :data:`PAGED_HEAD_DIMS`, and
    bf16 q, int32 table and lens plus ``tensors`` (name, tensor, dtype), all
    contiguous on q's device."""
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {q.device}")
    b, h, d = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"{fn}: k/v pages must be [P, page, Hkv, D], got "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    hkv, dk = k_pages.shape[2:]
    if dk != d or h % hkv or h // hkv > 8:
        raise ValueError(f"{fn}: unsupported heads/dims: H={h} Hkv={hkv} D={d}")
    if d not in PAGED_HEAD_DIMS:
        raise ValueError(f"{fn}: head_dim {d} not in {PAGED_HEAD_DIMS}")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError(f"{fn}: page pools must be 16-byte aligned")
    if page_table.dim() != 2 or page_table.shape[0] != b or lens.shape != (b,):
        raise ValueError(f"{fn}: page_table must be [B, NB] and lens [B]")
    for name, t, dtype in (("q", q, torch.bfloat16), *tensors,
                           ("page_table", page_table, torch.int32),
                           ("lens", lens, torch.int32)):
        if t.dtype != dtype or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous {dtype} tensor on {q.device}")


def paged_attention_quant_plain(q: torch.Tensor, k_q: torch.Tensor, k_s: torch.Tensor,
                                v_q: torch.Tensor, v_s: torch.Tensor,
                                page_table: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """The int8 kernel's function in plain PyTorch, in float32.

    q [B, H, D]; k_q/v_q int8 [P, page, Hkv, D]; k_s/v_s f16 [P, page, Hkv];
    page_table [B, NB]; lens [B] → [B, H, D] in q's dtype. Gathers each
    row's pages, dequantizes them (codes × scale) and attends as
    :func:`paged_attention_plain` does. Positions past a row's length are
    masked with ``torch.where`` on the dequantized values, so a NaN scale
    there cannot leak (``0 × NaN`` would)."""
    b = q.shape[0]
    _, page, hkv, d = k_q.shape
    window = page_table.shape[1] * page
    table = page_table.long()

    def dense(codes, scales):
        x = codes[table].float() * scales[table].float()[..., None]
        return x.reshape(b, window, hkv, d)

    return _attend(q, dense(k_q, k_s), dense(v_q, v_s), lens)


def paged_attention_quant(q: torch.Tensor, k_q: torch.Tensor, k_s: torch.Tensor,
                          v_q: torch.Tensor, v_s: torch.Tensor,
                          page_table: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Decode attention over one layer's int8 page pool → [B, H, D].

    CUDA tensors launch the hand-written kernel (bf16 q, int8 payloads
    aligned to 16 bytes, f16 scales, D in 32/64/128/256, int32 table and
    lens, all contiguous); CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return paged_attention_quant_plain(q, k_q, k_s, v_q, v_s, page_table, lens)
    _check("paged_attention_quant", q, k_q, v_q, page_table, lens,
           tensors=(("k_q", k_q, torch.int8), ("k_s", k_s, torch.float16),
                    ("v_q", v_q, torch.int8), ("v_s", v_s, torch.float16)))
    if k_s.shape != k_q.shape[:-1] or v_s.shape != k_q.shape[:-1]:
        raise ValueError(f"paged_attention_quant: k/v scales must be [P, page, Hkv], got "
                         f"{tuple(k_s.shape)} / {tuple(v_s.shape)}")
    return _launch(KERNEL_QUANT, q, k_q, k_s, v_q, v_s, page_table, lens)


def quant_occupancy(kernel: CudaKernel, rep: int, head_dim: int, page: int) -> int:
    """Blocks of a build of the int8 split kernel that one SM holds at once,
    by the CUDA runtime's count of its registers and shared memory."""
    fn = kernel.function("paged_attention_int8_occupancy", [ctypes.c_int] * 3
                         + [ctypes.POINTER(ctypes.c_int)])
    blocks = ctypes.c_int(0)
    code = fn(rep, head_dim, page, ctypes.byref(blocks))
    if code != 0:
        raise RuntimeError(f"{kernel.name}: occupancy query failed with error {code}")
    return blocks.value
