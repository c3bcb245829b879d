"""The PyTorch port's primitives (sentio_tpu_torch/models/layers.py) against
their JAX counterparts (sentio_tpu/models/layers.py) on the same numpy
inputs, in float32. Tolerance: atol 1e-6 — the same arithmetic in the same
precision, summed in a different order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentio_tpu.models import layers as J
from sentio_tpu_torch.models import layers as T

ATOL = 1e-6


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(torch_out, jax_out, atol=ATOL):
    np.testing.assert_allclose(torch_out.detach().numpy(), np.asarray(jax_out),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("with_bias", [True, False])
def test_dense_matches_and_owns_layout(with_bias):
    rng = _rng(1)
    kernel = rng.standard_normal((24, 40)).astype(np.float32)  # JAX [in, out]
    x = rng.standard_normal((3, 5, 24)).astype(np.float32)
    jp = {"kernel": jnp.asarray(kernel)}
    tp = {"weight": torch.from_numpy(kernel.T.copy())}  # port [out, in]
    if with_bias:
        bias = rng.standard_normal(40).astype(np.float32)
        jp["bias"], tp["bias"] = jnp.asarray(bias), torch.from_numpy(bias)
    _close(T.dense(tp, torch.from_numpy(x), torch.float32),
           J.dense(jp, jnp.asarray(x), jnp.float32))


def test_embed():
    rng = _rng(2)
    table = rng.standard_normal((50, 16)).astype(np.float32)
    ids = rng.integers(0, 50, (2, 7))
    _close(T.embed({"embedding": torch.from_numpy(table)}, torch.from_numpy(ids), torch.float32),
           J.embed({"embedding": jnp.asarray(table)}, jnp.asarray(ids), jnp.float32))


def test_layernorm_eps_and_affine():
    rng = _rng(3)
    x = rng.standard_normal((4, 6, 32)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(32).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    _close(T.layernorm({"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)},
                       torch.from_numpy(x)),
           J.layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                       jnp.asarray(x)))


def test_rmsnorm():
    rng = _rng(4)
    x = rng.standard_normal((4, 6, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    _close(T.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x)),
           J.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))


@pytest.mark.parametrize("head_dim,max_len,theta", [(16, 64, 10_000.0), (128, 8192, 500_000.0)])
def test_rope_tables_exact(head_dim, max_len, theta):
    tc, ts = T.rope_frequencies(head_dim, max_len, theta)
    jc, js = J.rope_frequencies(head_dim, max_len, theta)
    # both build in float64 and cast once: bit-identical, even at 8K with theta 5e5
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_apply_rope_rotates_halves():
    rng = _rng(5)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 60, (2, 5))
    tc, ts = T.rope_frequencies(16, 64)
    jc, js = J.rope_frequencies(16, 64)
    _close(T.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), tc, ts),
           J.apply_rope(jnp.asarray(x), jnp.asarray(pos), jc, js))


@pytest.mark.parametrize("masked", ["none", "causal", "padded_rows"])
def test_attention(masked):
    rng = _rng(6)
    q = rng.standard_normal((2, 9, 3, 8)).astype(np.float32)
    k = rng.standard_normal((2, 9, 3, 8)).astype(np.float32)
    v = rng.standard_normal((2, 9, 3, 8)).astype(np.float32)
    if masked == "none":
        tm = jm = None
    elif masked == "causal":
        tm, jm = T.causal_mask(9), J.causal_mask(9)
    else:
        # second row has no attendable key: both average every key uniformly
        m = np.ones((2, 9), bool)
        m[0, 5:] = False
        m[1, :] = False
        tm, jm = torch.from_numpy(m)[:, None, None, :], jnp.asarray(m)[:, None, None, :]
    _close(T.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                       tm, torch.float32),
           J.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm, jnp.float32))


@pytest.mark.parametrize("masked", ["none", "causal", "per_row"])
def test_attention_in_query_blocks_is_unchanged(masked, monkeypatch):
    """Past ``ATTENTION_SCORE_BYTES`` the queries go in blocks (here of 2):
    every query row's result is the unblocked one's (the products' sums may
    run in another order), whatever the mask's shape."""
    rng = _rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 9, 3, 8)).astype(np.float32))
               for _ in range(3))
    mask = {"none": None, "causal": T.causal_mask(9),
            "per_row": torch.from_numpy(rng.random((2, 1, 9, 9)) < 0.7)}[masked]
    whole = T.attention(q, k, v, mask, torch.float32)
    monkeypatch.setattr(T, "ATTENTION_SCORE_BYTES", 2 * 3 * 9 * 4 * 2)
    np.testing.assert_allclose(T.attention(q, k, v, mask, torch.float32).numpy(),
                               whole.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_rep", [1, 2, 4])
def test_repeat_kv(n_rep):
    x = _rng(7).standard_normal((2, 5, 2, 4)).astype(np.float32)
    _close(T.repeat_kv(torch.from_numpy(x), n_rep), J.repeat_kv(jnp.asarray(x), n_rep), atol=0)


@pytest.mark.parametrize("t,s,offset", [(5, None, 0), (3, 8, 4)])
def test_causal_mask(t, s, offset):
    np.testing.assert_array_equal(T.causal_mask(t, s, offset).numpy(),
                                  np.asarray(J.causal_mask(t, s, offset)))
