"""Pipeline parallelism: GPipe-style microbatched execution over ``pp`` —
the counterpart of ``sentio_tpu/parallel/pipeline.py``.

* The decoder's layers are stacked (``[L, ...]`` leaves,
  ``models/llama.py::stack_layer_params``) and the leading layer dim is
  split over the ``pp`` mesh axis: each pp coordinate holds a contiguous
  stage of L/S layers, with ``LLAMA_TP_RULES``' Megatron split inside each
  layer over ``tp``. The embedding, the final norm and the LM head
  replicate (they run outside the pipeline, on the first stage's device).
* The schedule is GPipe: M microbatches drain through S stages in
  M + S − 1 steps; at step t stage r runs microbatch t − r with that
  microbatch's pad mask, and each step's outputs hop one stage to the
  right (:func:`~.collectives.ppermute`). JAX computes the fill and drain
  bubbles on clamped microbatches and discards them; here they are
  skipped, the same answer. The last stage's outputs go home to the first
  stage's device.
* The residual stream is float32 end to end, as JAX's is (each block's
  products still run in the model dtype), so at bf16 the pipeline's loss
  is not ``llama_loss``'s: the port matches JAX's pipeline.
* Backward is autograd through the schedule, as JAX's is ``jax.grad``
  through it: no hand-written backward schedule (1F1B would be an
  optimisation, not a correctness requirement).
"""

from __future__ import annotations

from typing import Optional

import torch

from sentio_tpu_torch.models import layers as L
from sentio_tpu_torch.models.llama import (
    LlamaConfig,
    ShardInputs,
    block_forward,
    home_device,
    layer_of,
    nll_sums,
    tp_block,
    weighted_mean,
)
from sentio_tpu_torch.parallel.collectives import broadcast, ppermute
from sentio_tpu_torch.parallel.mesh import AXIS_PP, Mesh
from sentio_tpu_torch.parallel.sharding import (
    LLAMA_TP_RULES,
    P,
    ShardedParams,
    TPShards,
    leaves,
    port_spec,
    shard_by_specs,
)

Tensor = torch.Tensor


class PipelineError(Exception):
    pass


def stacked_param_shardings(stacked: dict, mesh: Optional[Mesh] = None) -> dict:
    """``{path: PartitionSpec}`` of the port's tensors in a
    ``stack_layer_params`` tree: embed, head and final norm replicated;
    the stacked layers over ``pp`` on the leading (layer) dim with the
    per-layer ``LLAMA_TP_RULES`` spec (read back to front for an ``[out,
    in]`` matrix) on the inner dims."""
    specs = {}
    for path, leaf in leaves(stacked):
        if path.startswith("layers/"):
            specs[path] = P(AXIS_PP, *port_spec(path, LLAMA_TP_RULES, leaf.dim() - 1))
        else:
            specs[path] = P()
    return specs


def shard_stacked_params(stacked: dict, mesh: Mesh) -> ShardedParams:
    """Place a stacked tree on the mesh by :func:`stacked_param_shardings`;
    the layers must divide by pp (:class:`PipelineError`)."""
    n_stages = mesh.shape[AXIS_PP]
    n_layers = next(leaf for _, leaf in leaves(stacked["layers"])).shape[0]
    if n_layers % n_stages != 0:
        raise PipelineError(f"{n_layers} layers not divisible by pp={n_stages}")
    specs = stacked_param_shardings(stacked, mesh)
    return shard_by_specs(stacked, mesh, LLAMA_TP_RULES, lambda path, _: specs[path])


def _stage_apply(local_layers, cfg: LlamaConfig, x: Tensor, positions: Tensor, cos: Tensor,
                 sin: Tensor, pad_mask: Optional[Tensor]) -> Tensor:
    """This stage's layer stack over activations x [mb, T, D] (float32: a
    float32 x plus a model-dtype block output stays float32).
    ``local_layers`` is the stage's stacked ``layers`` tree, or a
    :class:`TPShards` of them (each block then a
    :func:`~..models.llama.tp_block`)."""
    first = local_layers[0] if isinstance(local_layers, TPShards) else local_layers
    n = next(leaf for _, leaf in leaves(first)).shape[0]
    if isinstance(local_layers, TPShards):
        inputs = ShardInputs(cfg, local_layers.devices, positions, pad_mask, 0, cos.shape[0])
        for j in range(n):
            x = tp_block([layer_of(tree, j) for tree in local_layers], cfg, x, inputs)
        return x
    for j in range(n):
        x = block_forward(layer_of(local_layers, j), cfg, x, positions, cos, sin, pad_mask)
    return x


def pipeline_apply(stages: list, cfg: LlamaConfig, stream: Tensor, positions: Tensor,
                   cos: Tensor, sin: Tensor, pad_stream: Tensor) -> Tensor:
    """Push a microbatch stream [M, mb, T, D] through every stage's layers
    (``stages``: each stage's local layers, as :func:`_stage_apply` takes
    them), pipelined; ``pad_stream`` [M, mb, T] holds the microbatches'
    pad masks. Returns the transformed stream, float32, on the first
    stage's device. One stage runs the microbatches merged into one batch
    (microbatching serves no purpose there), as JAX does."""
    stream = stream.float()
    n_micro, mb, t, d = stream.shape
    if len(stages) == 1:
        pos = positions[:1].expand(n_micro * mb, t)
        out = _stage_apply(stages[0], cfg, stream.reshape(n_micro * mb, t, d), pos, cos, sin,
                           pad_stream.reshape(n_micro * mb, t))
        return out.reshape(n_micro, mb, t, d)

    n_stages = len(stages)
    devices = [home_device(s) for s in stages]
    ropes = [(cos, sin) if dev == cos.device else
             L.rope_frequencies(cfg.head_dim, cos.shape[0], cfg.rope_theta, dev)
             for dev in devices]
    pos_s = broadcast(positions, devices)
    pad_s = broadcast(pad_stream, devices)
    perm = [(r, r + 1) for r in range(n_stages - 1)]
    recv: list = [None] * n_stages
    outs: list = [None] * n_micro
    for step in range(n_micro + n_stages - 1):
        ys: list = [None] * n_stages
        for r in range(n_stages):
            m = step - r  # stage r runs microbatch step - r
            if 0 <= m < n_micro:
                x = stream[m] if r == 0 else recv[r]
                ys[r] = _stage_apply(stages[r], cfg, x, pos_s[r], *ropes[r], pad_s[r][m])
        if ys[-1] is not None:
            outs[step - (n_stages - 1)] = ys[-1].to(devices[0], non_blocking=True)
        recv = ppermute(ys, perm, devices)
    return torch.stack(outs)


def pipeline_loss(stacked, cfg: LlamaConfig, ids: Tensor, mask: Tensor,
                  mesh: Optional[Mesh] = None, n_micro: int = 2) -> Tensor:
    """Mean next-token cross-entropy through the layer pipeline, the pp
    analogue of ``llama_loss``. ``ids`` / ``mask`` [B, T+1]; B must divide
    into ``n_micro`` microbatches (:class:`PipelineError`). ``stacked`` a
    :func:`shard_stacked_params` tree, or a plain ``stack_layer_params``
    tree, which is placed on ``mesh`` here (the copies stay in autograd's
    graph, so its gradients reach the plain tree) or runs as one stage
    without a mesh. The batch splits over the data coordinates where each
    group still divides into the microbatches; the groups' sums meet in
    ``weighted_mean``."""
    b, t = ids.shape[0], ids.shape[1] - 1
    if b % n_micro != 0:
        raise PipelineError(f"batch {b} not divisible by n_micro={n_micro}")
    if not isinstance(stacked, ShardedParams) and mesh is not None:
        stacked = shard_stacked_params(stacked, mesh)
    if isinstance(stacked, ShardedParams):
        rows = stacked.rows if b % (stacked.rows * n_micro) == 0 else 1
        n_stages = stacked.mesh.shape[AXIS_PP]
        groups = []
        for g in range(rows):
            parts = [stacked.group(g, r) for r in range(n_stages)]
            stages = [TPShards([tree["layers"] for tree in p], p.devices)
                      if isinstance(p, TPShards) else p["layers"] for p in parts]
            outer = parts[0][0] if isinstance(parts[0], TPShards) else parts[0]
            groups.append((slice(g * (b // rows), (g + 1) * (b // rows)), outer, stages))
    else:
        groups = [(slice(None), stacked, [stacked["layers"]])]

    dt = cfg.torch_dtype
    terms = []
    for rows_g, outer, stages in groups:
        dev = home_device(outer)
        g_ids, g_mask = ids[rows_g].to(dev), mask[rows_g].to(dev)
        inp, pm = g_ids[:, :-1], g_mask[:, :-1]
        bg = inp.shape[0]
        mb = bg // n_micro
        positions = torch.arange(t, device=dev)[None, :].expand(mb, t)
        cos, sin = L.rope_frequencies(cfg.head_dim, max(t, cfg.max_len), cfg.rope_theta, dev)
        x = L.embed(outer["embed_tokens"], inp, dt)  # [Bg, T, D]
        out = pipeline_apply(stages, cfg, x.reshape(n_micro, mb, t, cfg.dim), positions, cos,
                             sin, pm.reshape(n_micro, mb, t))
        h = L.rmsnorm(outer["final_norm"], out.reshape(bg, t, cfg.dim), cfg.norm_eps)
        logits = L.dense(outer["lm_head"], h, dt).float()
        terms.append(nll_sums(logits, g_ids, g_mask))
    return weighted_mean(terms, home_device(groups[0][1]))
