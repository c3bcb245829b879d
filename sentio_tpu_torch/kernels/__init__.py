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
from sentio_tpu_torch.kernels.ring_attention import (
    ring_attention,
    ring_attention_sharded,
    ring_devices,
    ring_over,
)
from sentio_tpu_torch.parallel.collectives import all_gather

__all__ = [
    "flash_attention", "paged_attention", "paged_attention_quant", "flash_attn_fn",
    "encoder_attn_fn", "default_attn_fn", "paged_attn_impl", "select_encoder_attn_fn",
    "ring_attention", "ring_attention_sharded", "make_ring_attn_fn", "make_mesh_attn_fn",
    "MeshAttention",
    "KERNELS", "FLASH_KERNEL", "PAGED_KERNEL", "PAGED_QUANT_KERNEL",
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


def make_ring_attn_fn(devices):
    """Causal ring attention for ``llama_forward(attn_fn=...)`` over the sp
    coordinates on ``devices`` (JAX's adapter for use inside ``shard_map``
    over the sequence axis): the sequence is cut into one chunk a
    coordinate and ``kv_lens`` masks by global key position. Keys past the
    queries (a prefill over a cache window, S >= T) are never attended,
    and the ring leaves them out."""

    def fn(q, k, v, kv_lens=None):
        t = q.shape[1]
        return ring_over(devices, q, k[:, :t], v[:, :t], kv_lens, causal=True)

    return fn


class MeshAttention:
    """Attention laid over the mesh, as JAX's ``make_mesh_attn_fn``: heads
    over ``tp``, the sequence over ``sp`` (the ring, causal only: a
    ``ValueError`` for ``causal=False`` at sp > 1), the batch over ``dp``
    where it divides (else every row on the first coordinate).

    It has two forms. Called on global [B, T, H, D] arrays it makes that
    split itself, raising ``ValueError`` where the heads do not divide over
    tp or T over sp (the engines test those shapes first). :meth:`shard`
    is one shard's part, JAX's function inside ``shard_map``: it launches
    the flash kernel on the heads it is given at sp 1 and rides the ring
    at sp > 1. The port's forwards already hold one shard's heads (the
    Megatron layout of ``tp_forward``) of one data group's rows, so the
    models call :meth:`shard` (``models/llama.py``'s ``_attn``)."""

    def __init__(self, mesh, causal: bool = True) -> None:
        if mesh.shape["sp"] > 1 and not causal:
            raise ValueError("sequence-parallel ring attention is causal-only")
        self.mesh = mesh
        self.causal = causal

    def shard(self, q, k, v, kv_lens=None):
        if self.mesh.shape["sp"] > 1:
            return make_ring_attn_fn(ring_devices(self.mesh, q.device))(q, k, v, kv_lens)
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), kv_lens,
                               causal=self.causal)

    def __call__(self, q, k, v, kv_lens=None):
        mesh = self.mesh
        sp, tp, dp = mesh.shape["sp"], mesh.shape["tp"], mesh.shape["dp"]
        b, t, h, _ = q.shape
        if h % tp != 0 or t % sp != 0:
            raise ValueError(f"heads {h} % tp {tp} or seq {t} % sp {sp} != 0")
        n_dp = dp if dp > 1 and b % dp == 0 else 1
        per_b, per_h = b // n_dp, h // tp
        rows = []
        for i in range(n_dp):
            batch = slice(i * per_b, (i + 1) * per_b)
            cols = []
            for j in range(tp):
                dev = mesh.devices[0, i, 0, 0, 0, j]
                heads = slice(j * per_h, (j + 1) * per_h)
                part = [x[batch, :, heads].to(dev) for x in (q, k, v)]
                lens = kv_lens[batch].to(dev) if kv_lens is not None else None
                cols.append(self.shard(*part, lens))
            rows.append(all_gather(cols, q.device, dim=2))
        return all_gather(rows, q.device, dim=0)


def make_mesh_attn_fn(mesh, causal: bool = True) -> MeshAttention:
    """JAX's name for :class:`MeshAttention` over ``mesh``."""
    return MeshAttention(mesh, causal)


def select_encoder_attn_fn(mesh, n_heads: int):
    """JAX's policy for encoder attention (embedder and cross-encoder, one
    definition so the sites cannot drift): the bidirectional flash kernel,
    per tp shard on a mesh with sp 1 whose ``tp`` divides the heads; None
    (plain attention over every head) on any other mesh: the ring is
    causal-only, so at sp > 1 the encoders run plain attention, as JAX's
    do."""
    if mesh is None or (mesh.shape["sp"] == 1 and n_heads % mesh.shape["tp"] == 0):
        return encoder_attn_fn
    return None


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
