"""The collectives of the mesh, for one process driving it, under JAX's
names: :func:`psum`, the sum over ``tp`` after each row-parallel product,
and :func:`all_gather`, the gather of the vocabulary-sharded logits over
``tp`` (and of the row-sharded index's candidates over every axis);
:func:`ppermute`, the ring's K/V rotation over ``sp`` and the pipeline's
stage hand-off over ``pp``; :func:`broadcast`, which hands one activation
to every shard; and :func:`psum_replicated_grads`, the sum of a
parameter's gradients over its replicated copies, which XLA inserts for
a replicated leaf under ``jax.grad``.

JAX has no file for this: XLA inserts the collectives. Here one process
drives the mesh (JAX's single-controller design), so a collective is
plain tensor work on the caller's streams:

* shards on one card (a mesh that repeats a device): an addition or a
  ``torch.cat`` on the caller's stream, nothing on the host, so a CUDA
  graph can capture it;
* shards on distinct cards: ``Tensor.to(device, non_blocking=True)``,
  which PyTorch orders by events between the two cards' current streams
  (the copy waits for the source's work, the destination's later work
  waits for the copy). Nothing in this repository has run that case on
  more than one card.

The sum adds the shards in order, so it is deterministic.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import torch

Tensor = torch.Tensor


def broadcast(x: Tensor, devices: Sequence[torch.device]) -> list[Tensor]:
    """``x`` on each of ``devices`` (the same tensor where it already is)."""
    return [x if x.device == d else x.to(d, non_blocking=True) for d in devices]


def psum(parts: Sequence[Tensor], device: torch.device) -> Tensor:
    """The sum of the shards' partial results, on ``device``."""
    out = parts[0].to(device, non_blocking=True)
    for part in parts[1:]:
        out = out + part.to(device, non_blocking=True)
    return out


def all_gather(parts: Sequence[Tensor], device: torch.device, dim: int = -1) -> Tensor:
    """The shards' slices concatenated along ``dim``, on ``device``."""
    return torch.cat([p.to(device, non_blocking=True) for p in parts], dim=dim)


def ppermute(parts: Sequence[Optional[Tensor]], perm: Sequence[tuple[int, int]],
             devices: Sequence[torch.device]) -> list[Optional[Tensor]]:
    """JAX's ``lax.ppermute``: for each ``(src, dst)`` of ``perm``, the part
    of coordinate ``src`` lands on coordinate ``dst``'s device; a
    coordinate that no pair targets gets None (JAX's zeros), as does one
    whose source is None. On one card it is index arithmetic."""
    out: list[Optional[Tensor]] = [None] * len(devices)
    for src, dst in perm:
        part = parts[src]
        if part is not None:
            out[dst] = part if part.device == devices[dst] else part.to(devices[dst],
                                                                        non_blocking=True)
    return out


def psum_replicated_grads(copies: Iterable[Sequence[Tensor]]) -> None:
    """Sum each group of a parameter's copies' gradients and give every
    copy the sum, so an optimizer steps each copy alike. ``copies``: per
    parameter slice, the distinct tensors that hold it (a mesh that
    repeats a device holds a slice once: autograd has summed its uses
    already). A copy that no forward read has no gradient and adds 0."""
    for group in copies:
        grads = [t.grad for t in group if t.grad is not None]
        if len(group) < 2 or not grads:
            continue
        total = psum(grads, group[0].device)
        for t in group:
            t.grad = total if t.device == total.device else total.to(t.device,
                                                                   non_blocking=True)
