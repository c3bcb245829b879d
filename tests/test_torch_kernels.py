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
from sentio_tpu_torch.kernels._build import CudaKernel
from sentio_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from sentio_tpu_torch.kernels.paged_attention import (
    PAGES_PER_SPAN,
    PAGES_PER_SPAN_QUANT,
    paged_attention,
    paged_attention_plain,
    paged_attention_quant,
    paged_attention_quant_plain,
    span_kernel,
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


def _paged_problem(rep, seed=0, lens=(0, 5, 17, 39)):
    """Ragged rows over a shuffled pool: a partial last page, a row sitting
    on scratch page 0 at length 0, NaN pages past every row's length (which
    neither version may touch) and large finite garbage in the current
    page's tail (which the position mask must hide). ``lens`` holds each
    row's current token; row 0 stays on the scratch page."""
    rng = np.random.default_rng(seed)
    b, hkv, d, page, nb, num_pages = 4, 2, 16, 8, 5, 24
    h = hkv * rep
    lens = np.asarray(lens, np.int32)
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


def _span_partials(q, kp, vp, table, lens, span_tokens):
    """Each row's keys cut into spans of ``span_tokens`` consecutive
    positions (the split kernel's spans of pages), and per span the
    unnormalised softmax state over its keys only: m [H], l [H], acc
    [H, D], in float32. A row with no key (lens < 0) has no span."""
    b, h, d = q.shape
    _, page, hkv, _ = kp.shape
    window = table.shape[1] * page
    k = kp[table.long()].reshape(b, window, hkv, d).repeat_interleave(h // hkv, dim=2)
    v = vp[table.long()].reshape(b, window, hkv, d).repeat_interleave(h // hkv, dim=2)
    parts = []
    for row in range(b):
        n_keys = int(lens[row]) + 1
        spans = []
        for lo in range(0, max(n_keys, 0), span_tokens):
            hi = min(lo + span_tokens, n_keys)
            sc = torch.einsum("hd,thd->ht", q[row], k[row, lo:hi]) / float(np.sqrt(d))
            m = sc.amax(dim=-1)
            p = torch.exp(sc - m[:, None])
            spans.append((m, p.sum(dim=-1), torch.einsum("ht,thd->hd", p, v[row, lo:hi])))
        parts.append(spans)
    return parts


def _merge_spans(spans, h, d):
    """The combine pass's log-sum-exp rule, spans in order: out = sum_s
    w_s acc_s / sum_s w_s l_s with w_s = exp(m_s - max m); 0 with no span."""
    if not spans:
        return torch.zeros((h, d))
    m_all = torch.stack([m for m, _, _ in spans]).amax(dim=0)
    l_tot, acc_tot = torch.zeros(h), torch.zeros((h, d))
    for m, l, acc in spans:
        w = torch.exp(m - m_all)
        l_tot = l_tot + w * l
        acc_tot = acc_tot + w[:, None] * acc
    return acc_tot / l_tot[:, None]


@pytest.mark.parametrize("pages_per_span", [1, 2])
@pytest.mark.parametrize("rep", [1, 2, 4])
def test_span_merge_matches_plain_and_pallas_interpret(rep, pages_per_span):
    """The split kernel's arithmetic on the CPU: per-span partials merged
    by the log-sum-exp rule equal the one-pass softmax of the plain version
    and the Pallas kernel. Rows: no key at all (lens -1, no span), one key
    (a single span of one token), a last span of one token (lens 16), and
    several full spans; NaN pages past every row's length stay unread."""
    q, kp, vp, table, _ = _paged_problem(rep, seed=rep)
    lens = np.asarray([-1, 0, 16, 39], np.int32)  # each <= _paged_problem's
    page = kp.shape[1]
    tq, tk, tv, tt, tl = (torch.from_numpy(a) for a in (q, kp, vp, table, lens))
    parts = _span_partials(tq, tk, tv, tt, tl, pages_per_span * page)
    assert [len(p) for p in parts] == [0, 1, -(-17 // (pages_per_span * page)),
                                       -(-40 // (pages_per_span * page))]
    got = torch.stack([_merge_spans(p, q.shape[1], q.shape[2]) for p in parts])
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), paged_attention_plain(tq, tk, tv, tt, tl).numpy(),
                               atol=ATOL, rtol=0)
    ref = jax_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
                    jnp.asarray(lens), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    assert not got[0].any()  # nothing to attend: exactly 0


def test_library_hash_covers_included_headers(tmp_path):
    """An edited header rebuilds: the library's name hashes the source and
    every header it includes with quotes, through nested includes."""
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("#pragma once\nconstexpr int kTile = 64;\n")
    kernel = CudaKernel("k", str(tmp_path / "k.cu"), "k_launch", [])
    assert [p.name for p in kernel.sources()] == ["k.cu", "a.cuh", "b.cuh"]
    before = kernel.library
    (tmp_path / "b.cuh").write_text("#pragma once\nconstexpr int kTile = 128;\n")
    assert kernel.library != before
    assert kernel.library.parent == before.parent
    # the repo's kernels: the shared helpers and the wgmma header are hashed
    assert {"cuda_common.cuh", "paged_common.cuh"} <= {p.name for p in PAGED_KERNEL.sources()}
    assert {"cuda_common.cuh", "paged_common.cuh"} <= {
        p.name for p in PAGED_QUANT_KERNEL.sources()}
    assert {"cuda_common.cuh", "wgmma.cuh"} <= {p.name for p in FLASH_KERNEL.sources()}


def test_library_name_covers_defines(tmp_path):
    """A build of one source with other ``-D`` defines is its own library;
    each paged kernel's span size is such a define, so each size of the
    sweep builds apart from the committed one."""
    (tmp_path / "k.cu").write_text("constexpr int kSpan = SPAN;\n")
    libs = {CudaKernel("k", str(tmp_path / "k.cu"), "k_launch", [], defines=d).library
            for d in ((), ("SPAN=1",), ("SPAN=2",))}
    assert len(libs) == 3 and len({lib.parent for lib in libs}) == 1
    for quant, kernel, committed in ((False, PAGED_KERNEL, PAGES_PER_SPAN),
                                     (True, PAGED_QUANT_KERNEL, PAGES_PER_SPAN_QUANT)):
        assert f"-DSENTIO_PAGES_PER_SPAN={committed}" in kernel.flags
        others = [span_kernel(n, quant) for n in (1, 2, 4) if n != committed]
        assert all(k.source == kernel.source and k.launches == 0 for k in others)
        assert len({kernel.library, *(k.library for k in others)}) == 1 + len(others)
        assert span_kernel(committed, quant).library == kernel.library
    assert PAGED_KERNEL.source != PAGED_QUANT_KERNEL.source


def _quant_problem(rep, seed=0, tail_scale=np.nan, lens=(0, 5, 17, 39)):
    """The ragged rows of :func:`_paged_problem` over an int8 pool quantized
    by the JAX ``quantize_kv``: random int8 codes and NaN scales on every
    page past a row's length, random codes and ``tail_scale`` in the
    current page's tail."""
    q, kp, vp, table, lens = _paged_problem(rep, seed, lens)
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


# The int8 kernel's order of d within each 16-wide group: the product's k
# indices 2t, 2t + 1, 2t + 8, 2t + 9 take d = 4t .. 4t + 3, the four codes
# an ldmatrix gives lane t (csrc/paged_attention_quant.cu).
_D_ORDER16 = [4 * (k % 8 // 2) + 2 * (k // 8) + k % 2 for k in range(16)]


def _upper_bf16(x):
    """The bf16 value of a float's upper 16 bits (truncation toward 0)."""
    return (x.view(torch.int32) & -65536).view(torch.float32)


def _quant_span_partials(q, k_q, k_s, v_q, v_s, table, lens, span_tokens, split_pv):
    """The int8 split kernel's arithmetic in float32: each row's keys cut
    into spans of ``span_tokens`` positions, per span the scores over the
    raw codes with d in the kernel's order (q and K permuted alike) times
    ks * sm_scale, m, l = sum p, and acc = sum (p * vs) Vq, with p * vs
    taken as the kernel's two bf16 operands, hi (its upper 16 bits) plus lo
    (the remainder's), when ``split_pv``. A row with no key has no span;
    slots past a row's length are never read."""
    b, h, d = q.shape
    _, page, hkv, _ = k_q.shape
    window = table.shape[1] * page
    order = [16 * (j // 16) + _D_ORDER16[j % 16] for j in range(d)]

    def gather(x):  # [P, page, Hkv, ...] -> [B, window, H, ...]
        x = x[table.long()].reshape(b, window, hkv, *x.shape[3:]).float()
        return x.repeat_interleave(h // hkv, dim=2)

    kq, ks, vq, vs = gather(k_q)[..., order], gather(k_s), gather(v_q), gather(v_s)
    qp = q[..., order]
    parts = []
    for row in range(b):
        n_keys = int(lens[row]) + 1
        spans = []
        for lo in range(0, max(n_keys, 0), span_tokens):
            hi = min(lo + span_tokens, n_keys)
            sc = (torch.einsum("hd,thd->ht", qp[row], kq[row, lo:hi]) * ks[row, lo:hi].T
                  / float(np.sqrt(d)))
            m = sc.amax(dim=-1)
            p = torch.exp(sc - m[:, None])
            pv = p * vs[row, lo:hi].T
            if split_pv:
                pv_hi = _upper_bf16(pv)
                pv = pv_hi + _upper_bf16(pv - pv_hi)
            spans.append((m, p.sum(dim=-1), torch.einsum("ht,thd->hd", pv, vq[row, lo:hi])))
        parts.append(spans)
    return parts


@pytest.mark.parametrize("pv", ["fp32", "hi_lo"])
@pytest.mark.parametrize("pages_per_span", [1, 2])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
def test_quant_span_merge_matches_plain_and_pallas_interpret(rep, pages_per_span, pv):
    """The int8 split kernel's arithmetic on the CPU: per-span partials with
    ks on the scores and vs folded into P, merged by the log-sum-exp rule,
    against the plain version and the Pallas kernel. Rows: no key, one key,
    a last span of one token (lens 16), several full spans. Tolerance: atol
    2e-5 with p * vs in fp32 (the TPU kernel's arithmetic); with p * vs as
    the kernel's hi + lo bf16 terms (which lose less than 2^-14 of it),
    2e-5 plus 2^-14 * max |V| over the row's keys of its kv head."""
    lens = (-1, 0, 16, 39)  # row 0 has no key
    tq, *pools, tt, tl = (torch.from_numpy(a) for a in _quant_problem(rep, seed=rep, lens=lens))
    page, span_tokens = pools[0].shape[1], pages_per_span * pools[0].shape[1]
    parts = _quant_span_partials(tq, *pools, tt, tl, span_tokens, pv == "hi_lo")
    assert [len(p) for p in parts] == [0, 1, -(-17 // span_tokens), -(-40 // span_tokens)]
    b, h, d = tq.shape
    got = torch.stack([_merge_spans(p, h, d) for p in parts])
    assert torch.isfinite(got).all() and not got[0].any()  # nothing to attend: exactly 0
    atol = torch.full((b, h, 1), ATOL)
    if pv == "hi_lo":
        hkv = pools[0].shape[2]
        v = pools[2].float() * pools[3].float()[..., None]  # NaN past each row's length
        for row in range(1, b):
            n = int(tl[row]) + 1
            keys = v[tt[row].long()].reshape(-1, hkv, d)[:n].nan_to_num(0.0)
            vmax = keys.abs().amax(dim=(0, 2)).repeat_interleave(h // hkv)
            atol[row, :, 0] += 2.0 ** -14 * vmax
    plain = paged_attention_quant_plain(tq, *pools, tt, tl)
    assert ((got - plain).abs() <= atol).all()
    # the Pallas kernel multiplies the whole current page's vs: finite
    # garbage there for it, the same rows otherwise
    args = _quant_problem(rep, seed=rep, tail_scale=1e3, lens=lens)
    ref = torch.from_numpy(np.array(jax_paged_quant(*(jnp.asarray(a) for a in args),
                                                    interpret=True)))
    assert ((got - ref).abs() <= atol).all()


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


def test_launch_counts_survive_concurrent_threads():
    """The service's pump and the chat threads count launches at once: no
    count is lost (a short switch interval makes an unlocked
    read-modify-write lose some)."""
    import sys
    import threading

    kernel = CudaKernel("stress", "flash_attention.cu", "flash_attention_bf16", [])
    per_thread, n_threads = 2000, 16
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [kernel.add_launches(1) for _ in range(per_thread)], daemon=True)
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert kernel.launches == per_thread * n_threads
