"""Token sampling: greedy / temperature / top-k / top-p — the counterpart
of ``sentio_tpu/runtime/sampling.py``.

Randomness comes from an explicit ``torch.Generator`` (Gumbel-max over
uniform draws). It cannot reproduce JAX's threefry bits, so sampled paths
agree with the JAX package in distribution only; greedy rows agree exactly.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

Tensor = torch.Tensor


def sample_tokens(
    logits: Tensor,
    generator: Optional[torch.Generator] = None,
    temperature: Union[Tensor, np.ndarray, float] = 0.0,
    top_k: Union[Tensor, np.ndarray, int] = 0,
    top_p: float = 1.0,
    *,
    all_greedy: Optional[bool] = None,
    any_top_k: Optional[bool] = None,
) -> tuple[Tensor, Tensor]:
    """[B, V] → ([B] int64 tokens, [B] float32 logprobs).

    ``temperature`` is a scalar or a per-row [B] vector; 0 = greedy.
    ``top_k`` is a scalar or per-row [B] vector; rows with k <= 0 keep the
    whole distribution. ``top_p`` applies to every row. The logprob is the
    chosen token's log-probability under the UNMODIFIED distribution (the
    log-softmax of the raw logits, before temperature or filtering).

    ``all_greedy`` (every row has temperature <= 0) and ``any_top_k`` (some
    row has k > 0) are host flags that decide which work runs. Left unset
    they are read from host values; a ``temperature`` tensor counts as not
    all greedy, and a ``top_k`` tensor is read from the device. A caller
    that passes device tensors and both flags reads nothing back from the
    device, so the call can be captured in a CUDA graph."""
    logits = logits.float()
    b, v = logits.shape
    device = logits.device
    greedy = logits.argmax(dim=-1)
    if all_greedy is None:
        all_greedy = (not isinstance(temperature, Tensor)
                      and bool(np.all(np.asarray(temperature) <= 0.0)))
    if all_greedy:
        chosen = greedy
    else:
        temp = torch.as_tensor(temperature, dtype=torch.float32, device=device)
        temp_rows = temp.expand(b) if temp.dim() == 0 else temp
        scaled = logits / temp_rows.clamp_min(1e-6)[:, None]
        k_rows = torch.as_tensor(top_k, dtype=torch.int64, device=device)
        k_rows = k_rows.expand(b) if k_rows.dim() == 0 else k_rows
        if any_top_k is None:
            any_top_k = (bool(np.any(np.asarray(top_k) > 0)) if not isinstance(top_k, Tensor)
                         else bool((k_rows > 0).any()))
        if any_top_k:
            # kth-largest per row via one ascending sort; values == kth
            # survive, rows with k <= 0 keep everything
            srt = scaled.sort(dim=-1).values
            idx = (v - k_rows).clamp(0, v - 1)[:, None]
            kth = srt.gather(-1, idx)
            scaled = torch.where((k_rows[:, None] > 0) & (scaled < kth),
                                 float("-inf"), scaled)
        if top_p < 1.0:
            sorted_logits = scaled.sort(dim=-1, descending=True).values
            cum = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
            # smallest prefix with cumulative prob >= top_p (>= 1 token)
            cutoff_idx = (cum >= top_p).int().argmax(dim=-1, keepdim=True)
            cutoff = sorted_logits.gather(-1, cutoff_idx)
            scaled = torch.where(scaled < cutoff, float("-inf"), scaled)
        u = torch.rand((b, v), generator=generator, device=device)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        sampled = (scaled + gumbel).argmax(dim=-1)
        chosen = torch.where(temp_rows <= 0.0, greedy, sampled)
    logprobs = torch.log_softmax(logits, dim=-1).gather(-1, chosen[:, None])[:, 0]
    return chosen, logprobs
