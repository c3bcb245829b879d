"""Ring attention: sequence parallelism over the ``sp`` mesh axis — the
counterpart of ``sentio_tpu/kernels/ring_attention.py``.

JAX's ring is einsums and ``lax.ppermute`` inside ``shard_map``, not a
Pallas kernel, and so is this one: ``torch.matmul``, the online-softmax
recurrence and :func:`~..parallel.collectives.ppermute`. Each sp
coordinate holds its local Q chunk on its own device for the whole ring,
while the K/V chunks rotate one coordinate to the right a step; after
``sp`` steps every Q chunk has seen every K/V chunk. On a mesh that
repeats a device the rotation is index arithmetic.

Numerics are JAX's: the running max ``m``, normaliser ``l`` and float32
accumulator carried across ring steps, so the result is softmax(QKᵀ)V
whatever the arrival order; masked scores are ``finfo(float32).min``
(not ``-inf``), a step whose running max is still that value contributes
nothing (the ``safe`` guard), and a query row with nothing to attend is 0.
Causality comes from the two chunks' global offsets: chunk ``c`` starts at
``c · T_loc`` for the queries and ``c · S_loc`` for the keys (JAX uses
``T_loc`` for both, the same thing when S == T). ``kv_lens`` masks keys
by global position. Output in q's dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from sentio_tpu_torch.parallel.collectives import all_gather, broadcast, ppermute

Tensor = torch.Tensor

NEG_INF = float(np.finfo(np.float32).min)

__all__ = ["ring_attention", "ring_attention_sharded", "NEG_INF"]


def _chunk_attend(q: Tensor, k: Tensor, q_offset: int, k_offset: int, causal: bool,
                  sm_scale: float, kv_lens: Optional[Tensor] = None) -> Tensor:
    """Scores of local q [B, T, H, D] against one k chunk [B, S, H, D]
    (both float32), masked by the global causal order derived from the two
    chunk offsets and by ``kv_lens`` [B]: the raw masked [B, H, T, S]."""
    s = torch.einsum("bthd,bshd->bhts", q, k) * sm_scale
    k_pos = k_offset + torch.arange(k.shape[1], device=q.device)
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)[:, None]
        s = torch.where((k_pos[None, :] <= q_pos)[None, None], s, NEG_INF)
    if kv_lens is not None:
        valid = k_pos[None, :] < kv_lens[:, None].long()  # [B, S]
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
    return s


def ring_attention(q_parts: Sequence[Tensor], k_parts: Sequence[Tensor],
                   v_parts: Sequence[Tensor], kv_lens: Optional[Tensor] = None, *,
                   causal: bool = True, sm_scale: Optional[float] = None) -> list[Tensor]:
    """The ring over the sp coordinates: ``q_parts`` / ``k_parts`` /
    ``v_parts`` are each coordinate's local sequence chunk [B, T_loc, H, D]
    on its device, kv heads already expanded to H; ``kv_lens`` [B] masks
    right-padding by global key position. Returns each coordinate's
    output chunk [B, T_loc, H, D] on its device."""
    sp = len(q_parts)
    devices = [q.device for q in q_parts]
    b, t_loc, h, d = q_parts[0].shape
    s_loc = k_parts[0].shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / float(np.sqrt(d))
    perm = [(i, (i + 1) % sp) for i in range(sp)]  # send k/v to the right
    lens = broadcast(kv_lens, devices) if kv_lens is not None else [None] * sp

    q32 = [q.float() for q in q_parts]
    m = [torch.full((b, h, t_loc, 1), NEG_INF, device=dev) for dev in devices]
    l = [torch.zeros((b, h, t_loc, 1), device=dev) for dev in devices]
    acc = [torch.zeros((b, h, t_loc, d), device=dev) for dev in devices]
    k_cur, v_cur = list(k_parts), list(v_parts)
    for step in range(sp):
        for i in range(sp):
            # the chunk held at step ``step`` came from coordinate i - step
            src = (i - step) % sp
            s = _chunk_attend(q32[i], k_cur[i].float(), i * t_loc, src * s_loc, causal,
                              scale, lens[i])
            m_new = torch.maximum(m[i], s.amax(dim=-1, keepdim=True))
            safe = m_new > NEG_INF / 2
            p = torch.exp(torch.where(safe, s - m_new, NEG_INF))
            alpha = torch.exp(torch.where(safe, m[i] - m_new, 0.0))
            l[i] = l[i] * alpha + p.sum(dim=-1, keepdim=True)
            acc[i] = acc[i] * alpha + torch.einsum("bhts,bshd->bhtd", p, v_cur[i].float())
            m[i] = m_new
        if step < sp - 1:  # JAX's last rotation only brings the chunks home
            k_cur, v_cur = ppermute(k_cur, perm, devices), ppermute(v_cur, perm, devices)
    return [(a / torch.where(n == 0.0, 1.0, n)).transpose(1, 2).to(q.dtype)
            for a, n, q in zip(acc, l, q_parts)]


def ring_devices(mesh, device: torch.device) -> list[torch.device]:
    """The sp coordinates' devices of the ring that ``device``'s shard
    rides: along ``sp`` from the first coordinate at sp 0 on ``device``
    (on a mesh that repeats a device every candidate's ring is that
    device)."""
    axis = mesh.axis_names.index("sp")
    for coord, dev in mesh.coords():
        if dev == device and coord[axis] == 0:
            index = list(coord)
            ring = []
            for j in range(mesh.shape["sp"]):
                index[axis] = j
                ring.append(mesh.devices[tuple(index)])
            return ring
    raise ValueError(f"{device} holds no coordinate of {mesh}")


def ring_over(devices: Sequence[torch.device], q: Tensor, k: Tensor, v: Tensor,
              kv_lens: Optional[Tensor] = None, causal: bool = True) -> Tensor:
    """One shard's [B, T, H, D] arrays through the ring over ``devices``:
    the sequence is cut into one chunk a coordinate (T must divide), the
    output gathered back on q's device."""
    sp = len(devices)
    if q.shape[1] % sp or k.shape[1] % sp:
        raise ValueError(f"sequence length {q.shape[1]} (keys {k.shape[1]}) not divisible "
                         f"by sp={sp}")

    def parts(x: Tensor) -> list[Tensor]:
        return [c.to(dev, non_blocking=True) for c, dev in zip(x.chunk(sp, dim=1), devices)]

    out = ring_attention(parts(q), parts(k), parts(v), kv_lens, causal=causal)
    return all_gather(out, q.device, dim=1)


def ring_attention_sharded(q: Tensor, k: Tensor, v: Tensor, mesh, *, causal: bool = True,
                           sp_axis: str = "sp", batch_axes: tuple[str, ...] = ("dp",),
                           kv_lens: Optional[Tensor] = None) -> Tensor:
    """Standalone entry: global [B, T, H, D] arrays, the batch split over
    ``batch_axes``, the sequence over ``sp_axis``; T must divide by the sp
    axis size (``ValueError``, as in JAX), and B by the batch axes'
    product. ``kv_lens`` [B] masks keys by global position. The output
    lands on q's device."""
    sp = mesh.shape[sp_axis]
    if q.shape[1] % sp != 0:
        raise ValueError(f"sequence length {q.shape[1]} not divisible by sp={sp}")
    groups = int(np.prod([mesh.shape[a] for a in batch_axes]))
    if q.shape[0] % groups != 0:
        raise ValueError(f"batch {q.shape[0]} not divisible by {batch_axes}={groups}")
    per = q.shape[0] // groups
    outs = []
    for g, block in enumerate(np.ndindex(*[mesh.shape[a] for a in batch_axes])):
        index = [0] * len(mesh.axis_names)
        for a, i in zip(batch_axes, block):
            index[mesh.axis_names.index(a)] = i
        axis = mesh.axis_names.index(sp_axis)
        devices = []
        for j in range(sp):
            index[axis] = j
            devices.append(mesh.devices[tuple(index)])
        rows = slice(g * per, (g + 1) * per)
        lens = kv_lens[rows] if kv_lens is not None else None
        outs.append(ring_over(devices, q[rows], k[rows], v[rows], lens, causal))
    return all_gather(outs, q.device, dim=0)
