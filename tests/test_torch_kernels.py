"""The port's kernel wrappers and plain versions.

The plain PyTorch versions stand in for the CUDA kernels on the CPU, so
they are held against the Pallas kernels they replace, run in interpret
mode — not against ``layers.attention``, which averages every key for a
row with nothing to attend where both kernels write 0. Tolerance: atol
2e-5 in float32, the tolerance tests/test_kernels.py holds the Pallas
kernels to (blockwise online softmax vs one-shot softmax)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentio_tpu.kernels.flash_attention import flash_attention as jax_flash
from sentio_tpu.kernels.paged_attention import paged_attention as jax_paged
from sentio_tpu.kernels.paged_attention import paged_attention_quant as jax_paged_quant
from sentio_tpu.runtime.paged import quantize_kv as jax_quantize
from sentio_tpu_torch import resolve_device
from sentio_tpu_torch.kernels import FLASH_KERNEL, PAGED_KERNEL, PAGED_QUANT_KERNEL
from sentio_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from sentio_tpu_torch.kernels.paged_attention import (
    paged_attention,
    paged_attention_plain,
    paged_attention_quant,
    paged_attention_quant_plain,
)

ATOL = 2e-5


def _qkv(b, t, s, h, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, h, d)).astype(np.float32)
    v = rng.standard_normal((b, s, h, d)).astype(np.float32)
    return q, k, v


FLASH_CASES = {
    # name: (B, T, H, D, kv_lens) — T=50 does not divide the 32-blocks
    "full_rows": (2, 64, 2, 16, [64, 64]),
    "ragged_non_divisible": (2, 50, 2, 16, [50, 17]),
    "zero_length_row": (3, 40, 2, 32, [0, 40, 9]),
    "single_key_rows": (2, 33, 1, 16, [1, 2]),
}


@pytest.mark.parametrize("causal", [False, True], ids=["bidirectional", "causal"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_matches_pallas_interpret(case, causal):
    b, t, h, d, lens = FLASH_CASES[case]
    q, k, v = _qkv(b, t, t, h, d, seed=len(case))
    lens = np.asarray(lens, np.int32)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
                    causal=causal, block_q=32, block_k=32, interpret=True)
    got = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                torch.from_numpy(lens), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    if (lens == 0).any():  # rows with nothing to attend are exactly 0
        assert not got[lens == 0].any()


def _paged_problem(rep, seed=0):
    """Ragged rows over a shuffled pool: a partial last page, a row sitting
    on scratch page 0 at length 0, NaN pages past every row's length (which
    neither version may touch) and large finite garbage in the current
    page's tail (which the position mask must hide)."""
    rng = np.random.default_rng(seed)
    b, hkv, d, page, nb, num_pages = 4, 2, 16, 8, 5, 24
    h = hkv * rep
    lens = np.asarray([0, 5, 17, 39], np.int32)  # index of the current token
    k_pages = rng.standard_normal((num_pages, page, hkv, d)).astype(np.float32)
    v_pages = rng.standard_normal((num_pages, page, hkv, d)).astype(np.float32)
    table = np.zeros((b, nb), np.int32)
    free = list(rng.permutation(np.arange(1, num_pages)))
    for row in range(1, b):
        used = lens[row] // page + 1
        owned = [int(free.pop()) for _ in range(nb)]
        table[row] = owned
        tail = lens[row] % page + 1
        k_pages[owned[used - 1], tail:] = 1e3
        v_pages[owned[used - 1], tail:] = 1e3
        for pid in owned[used:]:
            k_pages[pid] = np.nan
            v_pages[pid] = np.nan
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    return q, k_pages, v_pages, table, lens


@pytest.mark.parametrize("rep", [1, 2, 4])
def test_paged_plain_matches_pallas_interpret(rep):
    q, kp, vp, table, lens = _paged_problem(rep, seed=rep)
    ref = jax_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
                    jnp.asarray(lens), interpret=True)
    got = paged_attention_plain(torch.from_numpy(q), torch.from_numpy(kp),
                                torch.from_numpy(vp), torch.from_numpy(table),
                                torch.from_numpy(lens))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def _quant_problem(rep, seed=0, tail_scale=np.nan):
    """The ragged rows of :func:`_paged_problem` over an int8 pool quantized
    by the JAX ``quantize_kv``: random int8 codes and NaN scales on every
    page past a row's length, random codes and ``tail_scale`` in the
    current page's tail."""
    q, kp, vp, table, lens = _paged_problem(rep, seed)
    rng = np.random.default_rng(seed + 100)
    page = kp.shape[1]
    pools = []
    for pages in (kp, vp):
        codes, scales = (np.array(a) for a in jax_quantize(jnp.asarray(np.nan_to_num(pages))))
        for row in range(1, len(lens)):
            used, tail = lens[row] // page + 1, lens[row] % page + 1
            owned = table[row]
            codes[owned[used - 1], tail:] = rng.integers(-128, 128, codes[0, tail:].shape)
            scales[owned[used - 1], tail:] = tail_scale
            for pid in owned[used:]:
                codes[pid] = rng.integers(-128, 128, codes[pid].shape)
                scales[pid] = np.nan
        pools += [codes, scales]
    return (q, *pools, table, lens)


@pytest.mark.parametrize("rep", [1, 2, 4, 8])
def test_paged_quant_plain_matches_pallas_interpret(rep):
    """Same int8 pool in, atol 2e-5 out. The Pallas kernel multiplies its
    probabilities by the value scales of the whole current page, so its
    tail scales are finite garbage here (a NaN there is 0 × NaN for it);
    pages past a row's length hold NaN scales, which neither reads."""
    args = _quant_problem(rep, seed=rep, tail_scale=1e3)
    ref = jax_paged_quant(*(jnp.asarray(a) for a in args), interpret=True)
    got = paged_attention_quant_plain(*(torch.from_numpy(a) for a in args))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    # the port's plain version masks by torch.where: NaN tail scales give
    # the very same output
    nan_tail = _quant_problem(rep, seed=rep, tail_scale=np.nan)
    torch.testing.assert_close(paged_attention_quant_plain(*(torch.from_numpy(a)
                                                             for a in nan_tail)),
                               got, rtol=0, atol=0)


def test_wrappers_take_the_plain_version_for_cpu_tensors():
    q, kp, vp, table, lens = (torch.from_numpy(a) for a in _paged_problem(2))
    launches = (PAGED_KERNEL.launches, PAGED_QUANT_KERNEL.launches, FLASH_KERNEL.launches)
    torch.testing.assert_close(paged_attention(q, kp, vp, table, lens),
                               paged_attention_plain(q, kp, vp, table, lens), rtol=0, atol=0)
    quant = [torch.from_numpy(a) for a in _quant_problem(2)]
    torch.testing.assert_close(paged_attention_quant(*quant),
                               paged_attention_quant_plain(*quant), rtol=0, atol=0)
    fq, fk, fv = (torch.from_numpy(a) for a in _qkv(2, 20, 20, 2, 16, seed=3))
    fl = torch.tensor([20, 7], dtype=torch.int32)
    for causal in (False, True):
        torch.testing.assert_close(flash_attention(fq, fk, fv, fl, causal=causal),
                                   flash_attention_plain(fq, fk, fv, fl, causal=causal),
                                   rtol=0, atol=0)
    # the plain path is not a kernel launch
    assert (PAGED_KERNEL.launches, PAGED_QUANT_KERNEL.launches,
            FLASH_KERNEL.launches) == launches


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_wrappers_refuse_other_devices():
    q = torch.empty((2, 4, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        paged_attention(q, q, q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        paged_attention_quant(q, q, q, q, q, q, q)
    x = torch.empty((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(x, x, x)
