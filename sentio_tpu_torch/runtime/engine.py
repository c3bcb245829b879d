"""The contiguous-cache generation engine — the counterpart of
``sentio_tpu/runtime/engine.py::GeneratorEngine``, the engine the JAX
service uses when ``USE_PAGED_KV=0``.

Each call is a batch of its own: prompts are right-padded into a
(batch bucket × prefill bucket) block, junk bucket rows included, and get a
fresh contiguous KV cache whose window is ``bucket(width + max_new)``
capped at the model's ``max_len``.

* **prefill** — the family's forward over the whole block with the causal
  flash kernel as its attention on the card (:func:`default_attn_fn`; the
  keys are the whole cache window, S >= T, and the kernel reads none past
  T), the model's plain masked attention on the CPU, as JAX picks flash on
  the TPU only;
* **decode** — one token per row per step at its own position, plain
  masked attention over the window (as in JAX);
* :meth:`generate` — the JAX engine's fused program (prefill, first-token
  sample, a scan of ``_stable_steps`` decode steps) as an eager loop that
  stops early once every row has hit EOS; the over-run past the caller's
  budget is cut on the host;
* :meth:`stream` — a host-stepped decode yielding UTF-8-safe text.

The model family follows the config (a :class:`~..models.moe.MoeConfig`
serves the routed decoder) or the checkpoint's meta, through JAX's
``forward_fn`` seam; ``pad_mask`` keeps padding, junk bucket rows and rows
already done out of routed-expert capacity, as in JAX. Sampling draws from
the engine's own ``torch.Generator``.

On a device mesh (``mesh``) the weights shard by the family's rules
(``LLAMA_TP_RULES``, or ``MOE_EP_RULES`` for a MoE model: its experts over
``ep``; or they come sharded) and the cache is laid out as JAX's
``P(None, dp, None, tp, None)``: a call's rows split over the data
coordinates when they divide (each group on its own devices), else every
row runs on the first, as JAX's ``make_mesh_attn_fn`` replicates an
indivisible batch (JAX's ``device_put`` of such a cache raises); within a
group the kv heads shard over ``tp``. The prefill's attention is JAX's
choice: at sp 1 each shard launches the causal flash kernel on its heads;
at sp > 1 the sequence rides the ring over the sp coordinates
(:func:`~..kernels.make_mesh_attn_fn`). Where JAX catches the attention's
``ValueError`` (heads that do not divide over tp, a width that does not
divide over sp) and falls back to plain attention, the engine tests the
shape before the call (:meth:`GeneratorEngine.prefill_attn_fn`).
``prefill_attention`` names the choice ("flash", "ring" or "plain") and
``ring_prefills`` counts the prefills the ring ran. ``device_stats``
reports the mesh's shape.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from sentio_tpu_torch import resolve_device
from sentio_tpu_torch.config import GeneratorConfig
from sentio_tpu_torch.kernels import default_attn_fn, make_mesh_attn_fn
from sentio_tpu_torch.models.llama import LlamaConfig, home_device, init_cache, init_tp_cache
from sentio_tpu_torch.models.moe import decoder_forward, decoder_rules, init_decoder
from sentio_tpu_torch.parallel.mesh import AXIS_SP, AXIS_TP
from sentio_tpu_torch.parallel.sharding import ShardedParams, TPShards, shard_params
from sentio_tpu_torch.models.tokenizer import ByteTokenizer, batch_encode
from sentio_tpu_torch.parallel.batcher import bucket_size, floor_bucket
from sentio_tpu_torch.runtime.paged import check_mesh_model
from sentio_tpu_torch.runtime.sampling import sample_tokens
from sentio_tpu_torch.runtime.weights import load_generator

Tensor = torch.Tensor


@dataclass
class GenerationResult:
    text: str
    tokens: list[int]
    prompt_tokens: int
    finish_reason: str  # "stop" | "length"
    latency_ms: float = 0.0

    def stats_dict(self) -> dict:
        """What a provider's ``stats`` sink gets; the contiguous engine
        keeps no logprob accumulators."""
        return {"tokens": len(self.tokens), "finish_reason": self.finish_reason}


class GeneratorEngine:
    PREFILL_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096)
    BATCH_BUCKETS = (1, 2, 4, 8, 16)
    STEP_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
    # decode steps between two host checks of "every row is done"
    DONE_CHECK_EVERY = 8

    def __init__(self, config: Optional[GeneratorConfig] = None,
                 model_config: Optional[LlamaConfig] = None, params: Optional[dict] = None,
                 mesh=None, rng_seed: int = 0, forward_fn=None, device=None,
                 tokenizer=None) -> None:
        self.config = config or GeneratorConfig()
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        explicit = params is not None
        if params is None and self.config.checkpoint_path:
            # the family rides the checkpoint's meta (llama or moe)
            params, model_config, ck_tok = load_generator(self.config.checkpoint_path,
                                                          self.config.tokenizer_path,
                                                          device=self.device)
            tokenizer = tokenizer or ck_tok
            explicit = True
        self.model_config = model_config or (
            LlamaConfig.tiny() if self.config.model_preset == "tiny" else LlamaConfig.llama3_8b())
        self.tokenizer = tokenizer or ByteTokenizer(self.model_config.vocab_size)
        self.forward_fn = decoder_forward(self.model_config, forward_fn, explicit)
        if params is None:
            init_gen = torch.Generator(device=self.device)
            init_gen.manual_seed(rng_seed)
            params = init_decoder(self.model_config, init_gen, self.device)
        # prefill attention: flash on the card, plain on the CPU; the ring
        # over sp on a mesh with sp > 1; None runs the plain path anywhere
        self.attn_fn = default_attn_fn(self.device)
        if mesh is not None:
            check_mesh_model(self.model_config, mesh)
            if not isinstance(params, ShardedParams):
                params = shard_params(params, mesh, decoder_rules(self.model_config))
            if mesh.shape[AXIS_SP] > 1:
                self.attn_fn = make_mesh_attn_fn(mesh)
        self.params = params
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(rng_seed + 17)
        # prefill dispatches and decode steps run, for launch-count checks,
        # and the prefills that rode the ring
        self.prefills = 0
        self.decode_steps = 0
        self.ring_prefills = 0

    @property
    def prefill_attention(self) -> str:
        """The prefill's attention: "ring" (sp > 1), "flash" (the kernel,
        on the card) or "plain"."""
        if self.attn_fn is None:
            return "plain"
        return "ring" if self.mesh is not None and self.mesh.shape[AXIS_SP] > 1 else (
            "flash" if self.device.type == "cuda" else "plain")

    def prefill_attn_fn(self, width: int):
        """The attention a prefill of ``width`` tokens runs: ``attn_fn``
        where the shape suits it, None (plain attention) where JAX's
        attention would raise and fall back: heads that do not divide
        over tp, or on a ring a width that does not divide over sp."""
        if self.mesh is None or self.attn_fn is None:
            return self.attn_fn
        if (self.model_config.n_heads % self.mesh.shape[AXIS_TP] != 0
                or width % self.mesh.shape[AXIS_SP] != 0):
            return None
        return self.attn_fn

    # ------------------------------------------------------------- helpers

    def _encode_batch(self, prompts: Sequence[str], max_new: int):
        """Right-padded ids [rows, width] (rows a batch bucket, width a
        prefill bucket), positions, true lengths (junk rows 1), the fresh
        cache of ``window`` positions, the real row count, the window and
        the mask of real (row, token) cells."""
        cfg = self.model_config
        # prompts always leave >= 8 decode slots in the window
        max_prompt = min(self.config.max_prompt_tokens, cfg.max_len - 8)
        ids, mask = batch_encode(self.tokenizer, prompts, max_len=max_prompt, add_bos=True)
        lens = mask.sum(axis=1).astype(np.int32)
        n = len(prompts)
        rows = bucket_size(n, self.BATCH_BUCKETS)
        width = bucket_size(ids.shape[1], self.PREFILL_BUCKETS)
        ids = np.pad(ids, ((0, rows - n), (0, width - ids.shape[1])),
                     constant_values=self.tokenizer.pad_id)
        lens = np.pad(lens, (0, rows - n), constant_values=1)
        pad_mask = (np.arange(width)[None, :] < lens[:, None]) & (np.arange(rows) < n)[:, None]
        window = min(cfg.max_len,
                     bucket_size(width + max_new, self.PREFILL_BUCKETS + (cfg.max_len,)))
        cache = self._init_cache(rows, window)
        positions = np.broadcast_to(np.arange(width, dtype=np.int32)[None, :], ids.shape)
        return ids, positions.copy(), lens, cache, n, window, pad_mask

    def _groups(self, rows: int) -> list:
        """``(row slice, parameters)`` of each data group of a call's
        ``rows``: one group off a mesh; on a mesh one a data coordinate
        when they divide the rows, else the first coordinate's alone.
        A group's parameters are its tp shards (a plain tree where one
        shard holds the whole model)."""
        if self.mesh is None:
            return [(slice(0, rows), self.params)]
        return self.params.groups(rows)

    def _init_cache(self, rows: int, window: int):
        """The call's fresh cache; on a mesh one per data group, each a list
        of the tp shards' caches (a plain cache at tp 1)."""
        cfg = self.model_config
        if self.mesh is None:
            return init_cache(cfg, rows, window, self.device)
        return [init_tp_cache(cfg, sl.stop - sl.start, window, params)
                if isinstance(params, TPShards) else
                init_cache(cfg, sl.stop - sl.start, window, home_device(params))
                for sl, params in self._groups(rows)]

    def _forward(self, ids: Tensor, cache, **kwargs) -> Tensor:
        """The family's forward over every data group → logits on the
        engine's device, rows in order. Per-row tensor arguments are cut
        to each group's rows and moved to its devices."""
        if self.mesh is None:
            return self.forward_fn(self.params, self.model_config, ids, cache=cache,
                                   **kwargs)[0]
        parts = []
        for (sl, params), group_cache in zip(self._groups(ids.shape[0]), cache):
            dev = home_device(params)
            args = {k: (v[sl].to(dev) if isinstance(v, Tensor) else v)
                    for k, v in kwargs.items()}
            logits, _ = self.forward_fn(params, self.model_config, ids[sl].to(dev),
                                        cache=group_cache, **args)
            parts.append(logits.to(self.device))
        return torch.cat(parts)

    def _stable_steps(self, requested: int, headroom: int) -> int:
        """The decode length: ``requested`` rounded UP to a step bucket
        (``generate`` cuts the over-run), clamped DOWN to a bucket by the
        cache's headroom (finish_reason "length") — JAX's rule, which bounds
        its compiled variants."""
        assert headroom >= 1, f"no KV headroom ({headroom}); prompt truncation failed"
        steps = min(bucket_size(max(requested, 1), self.STEP_BUCKETS), max(self.STEP_BUCKETS))
        if steps > headroom:
            steps = floor_bucket(headroom, self.STEP_BUCKETS)
        return max(min(steps, headroom), 1)

    def _tensor(self, arr: np.ndarray, dtype=torch.int64) -> Tensor:
        return torch.as_tensor(np.asarray(arr), dtype=dtype, device=self.device)

    def _prefill(self, ids, positions, cache, pad_mask) -> Tensor:
        """Prefill the block at cache offset 0 → logits [rows, width, V]."""
        self.prefills += 1
        attn_fn = self.prefill_attn_fn(ids.shape[1])
        if attn_fn is not None and self.prefill_attention == "ring":
            self.ring_prefills += 1
        return self._forward(self._tensor(ids), cache, positions=self._tensor(positions),
                             cache_index=0, pad_mask=self._tensor(pad_mask, torch.bool),
                             attn_fn=attn_fn)

    def _decode_step(self, tok: Tensor, lens: Tensor, cache, temperature: float,
                     top_k: int, live: Optional[Tensor] = None) -> Tensor:
        """One token per row at position ``lens`` → the sampled next [rows].
        ``live`` [rows] (None: every row) marks the rows that route."""
        self.decode_steps += 1
        logits = self._forward(tok[:, None], cache, positions=lens[:, None], cache_index=lens,
                               pad_mask=None if live is None else live[:, None])
        return sample_tokens(logits[:, -1], self._gen, temperature, top_k=top_k)[0]

    def _generate_fused(self, ids, positions, lens, cache, temperature: float, steps: int,
                        top_k: int, pad_mask, n: int) -> np.ndarray:
        """Prefill, first-token sample and ``steps - 1`` decode steps →
        tokens [rows, steps]; a row that sampled EOS emits EOS from then on.
        The loop stops once the ``n`` real rows are done (checked every
        DONE_CHECK_EVERY steps) and fills the rest with EOS, as the full
        scan would."""
        eos = self.tokenizer.eos_id
        logits = self._prefill(ids, positions, cache, pad_mask)
        lens_t = self._tensor(lens)
        rows = torch.arange(lens_t.shape[0], device=self.device)
        tok = sample_tokens(logits[rows, lens_t - 1], self._gen, temperature, top_k=top_k)[0]
        del logits
        # junk bucket rows count as done: their tokens are never read
        done = (tok == eos) | (rows >= n)
        toks = [tok]
        for step in range(1, steps):
            if step % self.DONE_CHECK_EVERY == 0 and bool(done.all()):
                break
            # done rows (junk rows too) leave routing: a finished row must
            # not keep claiming expert capacity from live rows
            nxt = self._decode_step(tok, lens_t, cache, temperature, top_k, live=~done)
            tok = torch.where(done, eos, nxt)
            done = done | (tok == eos)
            lens_t = lens_t + 1
            toks.append(tok)
        out = np.full((len(lens), steps), eos, np.int64)
        out[:, : len(toks)] = torch.stack(toks, dim=1).cpu().numpy()
        return out

    # -------------------------------------------------------------- public

    def generate(self, prompts: Sequence[str], max_new_tokens: Optional[int] = None,
                 temperature: Optional[float] = None, top_k: int = 0
                 ) -> list[GenerationResult]:
        """Batched generation; batches past the largest batch bucket are
        chunked."""
        max_batch = max(self.BATCH_BUCKETS)
        if len(prompts) > max_batch:
            out: list[GenerationResult] = []
            for start in range(0, len(prompts), max_batch):
                out.extend(self.generate(prompts[start : start + max_batch],
                                         max_new_tokens=max_new_tokens,
                                         temperature=temperature, top_k=top_k))
            return out
        t0 = time.perf_counter()
        requested = max_new_tokens or self.config.max_new_tokens
        temp = self.config.temperature() if temperature is None else temperature
        ids, positions, lens, cache, n, window, pad_mask = self._encode_batch(prompts, requested)
        steps = self._stable_steps(requested, window - int(lens.max()))
        toks = self._generate_fused(ids, positions, lens, cache, temp, steps, top_k, pad_mask,
                                    n)
        dt_ms = (time.perf_counter() - t0) * 1000.0
        out = []
        for i in range(n):
            # the over-run past the caller's budget is dropped: an EOS in it
            # must not flip the reason
            row = toks[i, :requested].tolist()
            if self.tokenizer.eos_id in row:
                row, reason = row[: row.index(self.tokenizer.eos_id)], "stop"
            else:
                reason = "length"
            out.append(GenerationResult(text=self.tokenizer.decode(row), tokens=row,
                                        prompt_tokens=int(lens[i]), finish_reason=reason,
                                        latency_ms=dt_ms))
        return out

    def stream(self, prompt: str, max_new_tokens: Optional[int] = None,
               temperature: Optional[float] = None, top_k: int = 0) -> Iterator[str]:
        """Host-stepped decode yielding text increments; a trailing
        replacement character (maybe an incomplete UTF-8 sequence) is held
        back until the next token resolves it."""
        max_new = max_new_tokens or self.config.max_new_tokens
        temp = self.config.temperature() if temperature is None else temperature
        ids, positions, lens, cache, _, window, pad_mask = self._encode_batch([prompt], max_new)
        # host-stepped: the caller's budget applies exactly, clamped only by
        # the cache window
        max_new = max(min(max_new, window - int(lens.max())), 1)
        logits = self._prefill(ids, positions, cache, pad_mask)
        lens_t = self._tensor(lens)
        tok = sample_tokens(logits[:, int(lens[0]) - 1], self._gen, temp, top_k=top_k)[0]
        del logits
        emitted: list[int] = []
        flushed = ""
        for _ in range(max_new):
            t = int(tok[0])
            if t == self.tokenizer.eos_id:
                break
            emitted.append(t)
            text = self.tokenizer.decode(emitted)
            safe = text[:-1] if text.endswith("�") else text
            if len(safe) > len(flushed):
                yield safe[len(flushed):]
                flushed = safe
            tok = self._decode_step(tok, lens_t, cache, temp, top_k)
            lens_t = lens_t + 1
        final = self.tokenizer.decode(emitted)
        if len(final) > len(flushed):
            yield final[len(flushed):]

    def device_stats(self) -> dict:
        """Health payload: the device, its count, the model's shape and, on
        the card, memory in use against the card's total."""
        cuda = self.device.type == "cuda"
        stats = {
            "platform": "gpu" if cuda else self.device.type,
            "n_devices": torch.cuda.device_count() if cuda else 1,
            "mesh": dict(self.mesh.shape) if self.mesh is not None else None,
            "model": {"layers": self.model_config.n_layers, "dim": self.model_config.dim,
                      "vocab": self.model_config.vocab_size},
        }
        if cuda:
            stats["memory"] = {
                "bytes_in_use": torch.cuda.memory_allocated(self.device),
                "bytes_limit": torch.cuda.get_device_properties(self.device).total_memory,
            }
        return stats
