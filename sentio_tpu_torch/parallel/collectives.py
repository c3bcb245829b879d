"""The two collectives of the Megatron layout, for one process driving a
mesh, under JAX's names: :func:`psum`, the sum over ``tp`` after each
row-parallel product, and :func:`all_gather`, the gather of the
vocabulary-sharded logits over ``tp`` (and of the row-sharded index's
candidates over every axis); and :func:`broadcast`, which hands one
activation to every shard.

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

from typing import Sequence

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
