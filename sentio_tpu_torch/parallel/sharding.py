"""Sharding rules: regex partition rules → per-device shards — the
counterpart of ``sentio_tpu/parallel/sharding.py``.

The rules are JAX's, written for JAX's parameter paths and its ``[in,
out]`` kernels. The port stores a dense layer as ``weight`` ``[out, in]``
(the one transpose in :mod:`sentio_tpu_torch.runtime.weights`), so a leaf's
path is mapped to JAX's (``…/wq/weight`` → ``…/wq/kernel``) before its rule
is looked up, and a matrix's spec is read back to front: JAX's "column"
split ``P(None, tp)`` cuts dim 0 of the port's tensor.

The Megatron layout: attention q/k/v and MLP gate/up column-sharded
(output features on ``tp``), attention out and MLP down row-sharded (input
features on ``tp``), so each transformer block needs exactly two sums over
``tp``; the Llama embedding table is sharded by vocabulary rows (a masked
lookup and a sum) and ``lm_head`` by vocabulary columns (the logits are
gathered).
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

import torch

from sentio_tpu_torch.parallel.mesh import (
    AXIS_DCN,
    AXIS_DP,
    AXIS_EP,
    AXIS_TP,
    Mesh,
    split_mesh_dp,
)


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: one entry per tensor dim, an axis name, a
    tuple of axis names or None (replicated); printed as JAX prints it."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)

    __str__ = __repr__


P = PartitionSpec

# (path regex, PartitionSpec). First match wins; unmatched params replicate.
# Paths are JAX's "/"-joined key paths, e.g. "layers_0/attn/wq/kernel".
Rules = Sequence[tuple[str, PartitionSpec]]

LLAMA_TP_RULES: Rules = (
    # embeddings: shard vocab dim (row) — logits gathered at the head
    (r".*embed_tokens/embedding$", P(AXIS_TP, None)),
    (r".*lm_head/kernel$", P(None, AXIS_TP)),
    # attention: q/k/v column-parallel, o row-parallel
    (r".*attn/(wq|wk|wv)/kernel$", P(None, AXIS_TP)),
    (r".*attn/wo/kernel$", P(AXIS_TP, None)),
    # swiglu mlp: gate/up column-parallel, down row-parallel
    (r".*mlp/(w_gate|w_up)/kernel$", P(None, AXIS_TP)),
    (r".*mlp/w_down/kernel$", P(AXIS_TP, None)),
    # norms replicate
    (r".*norm.*", P()),
)

# MoE decoder: attention follows the Llama layout; expert stacks shard
# experts over ``ep`` on the leading dim and keep the Megatron split of each
# expert's product over ``tp`` (the stacks keep JAX's [E, in, out] layout,
# so these specs apply as written); the router replicates. The default
# rules of a MoE model on a mesh (``models.moe.decoder_rules``).
MOE_EP_RULES: Rules = (
    (r".*moe/router/kernel$", P()),
    (r".*moe/(w_gate|w_up)$", P(AXIS_EP, None, AXIS_TP)),
    (r".*moe/w_down$", P(AXIS_EP, AXIS_TP, None)),
) + tuple(LLAMA_TP_RULES)

ENCODER_TP_RULES: Rules = (
    (r".*embed(_tokens|_positions)?/embedding$", P(None, None)),
    (r".*attn/(wq|wk|wv)/kernel$", P(None, AXIS_TP)),
    (r".*attn/wo/kernel$", P(AXIS_TP, None)),
    (r".*mlp/(w_gate|w_up|w_in)/kernel$", P(None, AXIS_TP)),
    (r".*mlp/(w_down|w_out)/kernel$", P(AXIS_TP, None)),
    (r".*", P()),
)


def spec_for(path: str, rules: Rules, ndim: int) -> PartitionSpec:
    """The PartitionSpec of one JAX parameter path; pads / truncates the
    spec to the tensor rank, as JAX's does."""
    for pattern, spec in rules:
        if re.match(pattern, path):
            entries = tuple(spec)
            if len(entries) > ndim:
                entries = entries[-ndim:] if ndim > 0 else ()
            elif len(entries) < ndim:
                entries = (None,) * (ndim - len(entries)) + entries
            return P(*entries)
    return P()


def jax_path(path: str) -> str:
    """A port leaf's path under JAX's names: a dense layer's ``weight`` is
    JAX's ``kernel``."""
    head, _, leaf = path.rpartition("/")
    return f"{head}/kernel" if leaf == "weight" and head else path


def port_spec(path: str, rules: Rules, ndim: int) -> PartitionSpec:
    """The spec of the port's tensor at ``path``: JAX's, read back to front
    for a dense layer's ``[out, in]`` weight."""
    spec = spec_for(jax_path(path), rules, ndim)
    return P(*reversed(spec)) if path.endswith("/weight") and ndim == 2 else spec


def leaves(tree: dict, prefix: str = ""):
    """``(path, tensor)`` for every leaf of a nested dict, in order."""
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            yield from leaves(value, path)
        else:
            yield path, value


def describe_shardings(params: dict, mesh: Optional[Mesh], rules: Rules) -> dict[str, str]:
    """``{JAX path: spec}`` for every leaf, as JAX's ``describe_shardings``
    prints it for the same tree."""
    return {jax_path(p): str(spec_for(jax_path(p), rules, leaf.dim()))
            for p, leaf in leaves(params)}


def _index(spec: PartitionSpec, shape, coord: dict, mesh: Mesh) -> tuple:
    """The (start, stop) of every dim of the shard at mesh coordinate
    ``coord`` (axis name → index)."""
    out = []
    for n, entry in zip(shape, spec):
        if entry is None:
            out.append((0, n))
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        parts, pos = 1, 0
        for a in axes:
            parts *= mesh.shape[a]
            pos = pos * mesh.shape[a] + coord[a]
        if n % parts:
            raise ValueError(f"dim of size {n} not divisible by the {parts} shards of "
                             f"{entry!r}")
        size = n // parts
        out.append((pos * size, (pos + 1) * size))
    return tuple(out)


def _set(tree: dict, path: str, value) -> None:
    *heads, leaf = path.split("/")
    for key in heads:
        tree = tree.setdefault(key, {})
    tree[leaf] = value


class TPShards(list):
    """One data coordinate's parameter trees, one per ``tp`` shard in order,
    with the device each lives on: the form the models' tensor-parallel
    forwards take. ``experts`` holds the same for every ``ep`` coordinate
    in order (this object first): a MoE layer's expert slices live on all
    of them."""

    def __init__(self, trees: Sequence[dict], devices: Sequence[torch.device]) -> None:
        super().__init__(trees)
        self.devices = list(devices)
        self.experts: list[TPShards] = [self]

    @property
    def tp(self) -> int:
        return len(self)


class ShardedParams:
    """A parameter tree placed on a mesh: every device coordinate holds its
    own tree of contiguous tensors on its device (``trees[coord]``). Shards
    that are the same slice on the same device are one tensor, and a shard
    that is its whole source on the source's device is the source."""

    def __init__(self, mesh: Mesh, rules: Rules, trees: dict,
                 slices: Optional[dict] = None) -> None:
        self.mesh = mesh
        self.rules = rules
        self.trees = trees
        # per coordinate, each leaf's (start, stop) per dim in its source
        self.slices = slices or {}

    def tp(self, row: int = 0, stage: int = 0) -> TPShards:
        """The ``tp`` shards of data coordinate ``row`` (``dcn`` × ``dp`` in
        order) at pipeline stage ``stage`` and the first coordinate of sp,
        with every ``ep`` coordinate's shards in ``experts`` where the
        rules split a leaf over ``ep``."""
        dp = self.mesh.shape[AXIS_DP]
        dcn_i, dp_i = divmod(row, dp)
        n_ep = self.mesh.shape[AXIS_EP] if self.splits(AXIS_EP) else 1

        def at(e: int) -> TPShards:
            coords = [(dcn_i, dp_i, stage, e, 0, t) for t in range(self.mesh.shape[AXIS_TP])]
            return TPShards([self.trees[c] for c in coords],
                            [self.mesh.devices[c] for c in coords])

        first = at(0)
        if n_ep > 1:
            first.experts = [first, *(at(e) for e in range(1, n_ep))]
        return first

    def group(self, row: int = 0, stage: int = 0):
        """What data coordinate ``row`` computes on: its :meth:`tp` shards,
        or their one plain tree where a single shard holds the whole model
        (tp 1 and no leaf split over ``ep``)."""
        shards = self.tp(row, stage)
        return shards[0] if shards.tp == 1 and len(shards.experts) == 1 else shards

    def groups(self, rows: int) -> list:
        """``(row slice, parameters)`` for each data group of a call's
        ``rows``: one a data coordinate where they divide the rows, else
        every row on the first coordinate (JAX replicates an indivisible
        batch)."""
        n = self.rows if rows % self.rows == 0 else 1
        per = rows // n
        return [(slice(g * per, (g + 1) * per), self.group(g)) for g in range(n)]

    def splits(self, axis: str) -> bool:
        """Whether a rule names ``axis`` (an axis no rule names replicates)."""
        for _, spec in self.rules:
            for entry in spec:
                if axis == entry or (isinstance(entry, tuple) and axis in entry):
                    return True
        return False

    def copies(self) -> list[list[torch.Tensor]]:
        """For each leaf slice held by more than one distinct tensor (the
        same slice on several devices), those tensors: what
        :func:`~.collectives.psum_replicated_grads` sums over."""
        groups: dict = {}
        for coord, tree in self.trees.items():
            for path, leaf in leaves(tree):
                key = (path, self.slices[coord][path])
                group = groups.setdefault(key, [])
                if all(leaf is not t for t in group):
                    group.append(leaf)
        return [g for g in groups.values() if len(g) > 1]

    def parameters(self) -> list[torch.Tensor]:
        """Every distinct tensor of every coordinate, once: what an
        optimizer steps."""
        seen: dict = {}
        for tree in self.trees.values():
            for _, leaf in leaves(tree):
                seen.setdefault(id(leaf), leaf)
        return list(seen.values())

    @property
    def rows(self) -> int:
        return self.mesh.shape[AXIS_DCN] * self.mesh.shape[AXIS_DP]

    def split(self, n: int) -> list["ShardedParams"]:
        """The shards of each of :func:`split_mesh_dp`'s ``n`` submeshes."""
        subs = split_mesh_dp(self.mesh, n)
        per = self.mesh.shape[AXIS_DP] // n
        out = []
        for i, sub in enumerate(subs):
            keep = [c for c in self.trees if i * per <= c[1] < (i + 1) * per]
            trees = {(c[0], c[1] - i * per, *c[2:]): self.trees[c] for c in keep}
            slices = {(c[0], c[1] - i * per, *c[2:]): self.slices[c] for c in keep
                      if c in self.slices}
            out.append(ShardedParams(sub, self.rules, trees, slices))
        return out


def shard_params(params: dict, mesh: Mesh, rules: Rules) -> ShardedParams:
    """Place a parameter tree onto the mesh by the rules: each coordinate
    gets its slice of every leaf as a contiguous tensor on its device."""
    return shard_by_specs(params, mesh, rules,
                          lambda path, leaf: port_spec(path, rules, leaf.dim()))


def shard_by_specs(params: dict, mesh: Mesh, rules: Rules, spec_of) -> ShardedParams:
    """:func:`shard_params` with each leaf's spec from ``spec_of(path,
    leaf)``; ``rules`` are recorded as the tree's (which axes they split)."""
    trees: dict = {coord: {} for coord, _ in mesh.coords()}
    slices: dict = {coord: {} for coord, _ in mesh.coords()}
    for path, leaf in leaves(params):
        spec = spec_of(path, leaf)
        made: dict = {}
        for coord, device in mesh.coords():
            index = _index(spec, leaf.shape, dict(zip(mesh.axis_names, coord)), mesh)
            key = (device, index)
            if key not in made:
                whole = all(lo == 0 and hi == n for (lo, hi), n in zip(index, leaf.shape))
                if whole and leaf.device == device:
                    made[key] = leaf
                else:
                    part = leaf[tuple(slice(lo, hi) for lo, hi in index)]
                    # storage of its own on a device named apart from the
                    # source's, as on a distinct card: ``Tensor.to`` keeps
                    # the storage where two names (``cuda``, ``cuda:0``)
                    # mean one card, and a step would then move it twice
                    made[key] = part.to(device, copy=device != leaf.device).contiguous()
            _set(trees[coord], path, made[key])
            slices[coord][path] = index
    return ShardedParams(mesh, rules, trees, slices)

