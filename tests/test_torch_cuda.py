"""The CUDA kernels against their plain versions on the card, and the
engine's decode sub-steps replayed from CUDA graphs against the same
sub-steps run eagerly.

Marked ``cuda``: on a host without a CUDA device every test here skips
(the decision is made in a fixture, at run time). On the card:
``python -m pytest tests/test_torch_cuda.py -q -m cuda``. Tolerance: the
bf16-output kernels against the float32 plain versions on the same
inputs (bf16 pages, or int8 codes with f16 scales), max abs error 2e-2
(bf16 outputs carry ~3 significant digits)."""

import pytest
import torch

from sentio_tpu_torch.kernels import FLASH_KERNEL, PAGED_KERNEL, PAGED_QUANT_KERNEL
from sentio_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from sentio_tpu_torch.kernels.paged_attention import (
    PAGES_PER_SPAN,
    PAGES_PER_SPAN_QUANT,
    _launch,
    paged_attention,
    paged_attention_plain,
    paged_attention_quant,
    paged_attention_quant_plain,
    span_kernel,
)
from sentio_tpu_torch.models.llama import LlamaConfig
from sentio_tpu_torch.runtime.paged import ContinuousBatchingEngine, quantize_kv

pytestmark = pytest.mark.cuda
ATOL = 2e-2


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _paged_inputs(dev, rep, d=64, page=16, nb=6, b=5, hkv=2, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    num_pages = 1 + b * nb
    kp = torch.randn((num_pages, page, hkv, d), generator=gen, device=dev, dtype=torch.bfloat16)
    vp = torch.randn((num_pages, page, hkv, d), generator=gen, device=dev, dtype=torch.bfloat16)
    table = torch.arange(1, num_pages, dtype=torch.int32, device=dev).reshape(b, nb)
    table[0] = 0  # a free slot on the scratch page
    lens = torch.tensor([0, 1, page - 1, page, nb * page - 1], dtype=torch.int32, device=dev)
    q = torch.randn((b, hkv * rep, d), generator=gen, device=dev, dtype=torch.bfloat16)
    return q, kp, vp, table, lens


@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_paged_kernel_matches_plain(dev, rep, d):
    q, kp, vp, table, lens = _paged_inputs(dev, rep, d=d)
    before = PAGED_KERNEL.launches
    out = paged_attention(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    assert PAGED_KERNEL.launches == before + 1
    ref = paged_attention_plain(q.float(), kp.float(), vp.float(), table, lens)
    assert (out.float() - ref).abs().max().item() <= ATOL


def _unowned(table, lens, page):
    """(page id, first unowned slot) for every slot past each row's current
    token: the tail of its current page and every page after it that the
    row owns, and scratch page 0 past slot 0."""
    slots = [(0, 1)]
    for row, n in enumerate(lens.tolist()):
        for i, pid in enumerate(table[row].tolist()):
            first = 0 if i * page > n else n - i * page + 1
            if pid and first < page:
                slots.append((pid, first))
    return slots


def _split_case(dev, lens_list, rep, d, page, nb, seed, hkv=2):
    """Rows over private shuffled pages (page 0 a scratch page for rows at
    length 0, which read its slot 0 only), NaN planted in every unowned
    slot."""
    b = len(lens_list)
    gen = torch.Generator(device=dev).manual_seed(seed)
    num_pages = 1 + b * nb
    kp = torch.randn((num_pages, page, hkv, d), generator=gen, device=dev, dtype=torch.bfloat16)
    vp = torch.randn((num_pages, page, hkv, d), generator=gen, device=dev, dtype=torch.bfloat16)
    perm = torch.randperm(num_pages - 1, generator=torch.Generator().manual_seed(seed)) + 1
    table = perm.to(torch.int32).reshape(b, nb).to(dev)
    lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    table[lens == 0] = 0
    for pid, first in _unowned(table, lens, page):
        kp[pid, first:] = float("nan")
        vp[pid, first:] = float("nan")
    q = torch.randn((b, hkv * rep, d), generator=gen, device=dev, dtype=torch.bfloat16)
    return q, kp, vp, table, lens


def _check_paged(q, kp, vp, table, lens, out):
    ref = paged_attention_plain(q.float(), kp.float(), vp.float(), table, lens)
    assert bool(out.isfinite().all())
    assert (out.float() - ref).abs().max().item() <= ATOL


@pytest.mark.parametrize("pages_per_span", [1, 2, 4])
def test_paged_kernel_rows_at_span_boundaries(dev, pages_per_span):
    """Lengths one short of, at and one past a span's last token (and the
    last slot of the table), for the committed span and its alternatives."""
    page, nb = 16, 12
    span = pages_per_span * page
    lens = [span - 1, span, span + 1, nb * page - 1, 2 * span - 1, 0]
    q, kp, vp, table, lens = _split_case(dev, lens, 4, 128, page, nb, seed=pages_per_span)
    kernel = PAGED_KERNEL if pages_per_span == PAGES_PER_SPAN else span_kernel(pages_per_span)
    before = kernel.launches
    out = _launch(kernel, q, kp, vp, table, lens)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    _check_paged(q, kp, vp, table, lens, out)
    if pages_per_span == PAGES_PER_SPAN:
        torch.testing.assert_close(paged_attention(q, kp, vp, table, lens), out, rtol=0, atol=0)


@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
def test_paged_kernel_one_long_row(dev, rep, d):
    """The chat's decode shape: one live row of ~3,300 tokens over
    128-token pages, seven idle slots at length 0, NaN in unowned slots."""
    lens = [0, 0, 0, 3299, 0, 0, 0, 0]
    q, kp, vp, table, lens = _split_case(dev, lens, rep, d, page=128, nb=32, seed=rep + d)
    out = paged_attention(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    _check_paged(q, kp, vp, table, lens, out)
    out2 = paged_attention(q, kp, vp, table, lens)
    assert torch.equal(out, out2)  # fixed merge order: the same bits every run


@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_paged_quant_kernel_matches_plain(dev, rep, d):
    """The bf16 cases' pools quantized, with NaN scales and random codes in
    the tail of each row's current page, which the kernel must not read."""
    q, kp, vp, table, lens = _paged_inputs(dev, rep, d=d)
    page = kp.shape[1]
    (k_q, k_s), (v_q, v_s) = quantize_kv(kp), quantize_kv(vp)
    for row, n in enumerate(lens.tolist()):
        pid, tail = int(table[row, n // page]), n % page + 1
        if pid:
            for codes, scales in ((k_q, k_s), (v_q, v_s)):
                codes[pid, tail:] = torch.randint_like(codes[pid, tail:], -128, 128)
                scales[pid, tail:] = float("nan")
    before = PAGED_QUANT_KERNEL.launches
    out = paged_attention_quant(q, k_q, k_s, v_q, v_s, table, lens)
    torch.cuda.synchronize()
    assert PAGED_QUANT_KERNEL.launches == before + 1
    ref = paged_attention_quant_plain(q.float(), k_q, k_s, v_q, v_s, table, lens)
    assert bool(out.isfinite().all())
    assert (out.float() - ref).abs().max().item() <= ATOL


def _quant_split_case(dev, lens_list, rep, d, page, nb, seed, hkv=2):
    """:func:`_split_case`'s rows over an int8 pool: the pools quantized,
    then random codes (-128 included) and NaN scales in every unowned slot,
    the scratch page's and each current page's whole tail included."""
    q, kp, vp, table, lens = _split_case(dev, lens_list, rep, d, page, nb, seed, hkv)
    (k_q, k_s), (v_q, v_s) = quantize_kv(kp), quantize_kv(vp)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    for pid, first in _unowned(table, lens, page):
        for codes, scales in ((k_q, k_s), (v_q, v_s)):
            codes[pid, first:] = torch.randint(-128, 128, codes[pid, first:].shape,
                                               generator=gen, device=dev, dtype=torch.int8)
            scales[pid, first:] = float("nan")
    return q, (k_q, k_s, v_q, v_s), table, lens


def _check_quant(q, pools, table, lens, out):
    ref = paged_attention_quant_plain(q.float(), *pools, table, lens)
    assert bool(out.isfinite().all())
    diff = (out.float() - ref).abs()
    assert diff.max().item() <= ATOL and diff.mean().item() <= 2e-3


@pytest.mark.parametrize("pages_per_span", [1, 2, 4])
def test_paged_quant_kernel_rows_at_span_boundaries(dev, pages_per_span):
    """The int8 kernel's span builds at 128-token pages: lengths one short
    of, at and one past a span's last token (a current page of one valid
    token, whose tail runs past the 32-row padding), and the table's last
    slot."""
    page, nb = 128, 12
    span = pages_per_span * page
    lens = [span - 1, span, span + 1, nb * page - 1, 2 * span - 1, 0]
    q, pools, table, lens = _quant_split_case(dev, lens, 4, 128, page, nb, seed=pages_per_span)
    kernel = (PAGED_QUANT_KERNEL if pages_per_span == PAGES_PER_SPAN_QUANT
              else span_kernel(pages_per_span, quant=True))
    before = kernel.launches
    out = _launch(kernel, q, *pools, table, lens)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    _check_quant(q, pools, table, lens, out)
    if pages_per_span == PAGES_PER_SPAN_QUANT:
        torch.testing.assert_close(paged_attention_quant(q, *pools, table, lens), out,
                                   rtol=0, atol=0)


@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
def test_paged_quant_kernel_one_long_row(dev, rep, d):
    """The chat's decode shape over an int8 pool: one live row of ~3,300
    tokens, seven idle slots at length 0, garbage in unowned slots; two
    launches give the same bits."""
    lens = [0, 0, 0, 3299, 0, 0, 0, 0]
    q, pools, table, lens = _quant_split_case(dev, lens, rep, d, page=128, nb=32, seed=rep + d)
    out = paged_attention_quant(q, *pools, table, lens)
    torch.cuda.synchronize()
    _check_quant(q, pools, table, lens, out)
    assert torch.equal(out, paged_attention_quant(q, *pools, table, lens))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("t", [100, 512])
def test_flash_kernel_matches_plain(dev, t, d, causal):
    """T a multiple of the 128-row query tile and not, several key tiles
    (causal: tiles past the diagonal skipped), a kv_lens == 0 entry, full
    rows and lengths that end inside a tile; mean error within 2e-3."""
    gen = torch.Generator(device=dev).manual_seed(t + d)
    b, h = 4, 2
    q, k, v = (torch.randn((b, t, h, d), generator=gen, device=dev, dtype=torch.bfloat16)
               for _ in range(3))
    lens = torch.tensor([0, t, t // 2 + 1, 65], dtype=torch.int32, device=dev)
    before = FLASH_KERNEL.launches
    out = flash_attention(q, k, v, lens, causal=causal)
    torch.cuda.synchronize()
    assert FLASH_KERNEL.launches == before + 1
    ref = flash_attention_plain(q.float(), k.float(), v.float(), lens, causal=causal)
    diff = (out.float() - ref).abs()
    assert diff.max().item() <= ATOL and diff.mean().item() <= 2e-3
    assert not out[0].any()  # kv_lens == 0: exactly zero
    assert torch.equal(flash_attention(q, k, v, None, causal=causal),
                       flash_attention(q, k, v, torch.full_like(lens, t), causal=causal))


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q, kp, vp, table, lens = _paged_inputs(dev, 2)
    with pytest.raises(ValueError):
        paged_attention(q.float(), kp, vp, table, lens)
    with pytest.raises(ValueError):
        paged_attention(q, kp, vp, table.long(), lens)
    (k_q, k_s), (v_q, v_s) = quantize_kv(kp), quantize_kv(vp)
    with pytest.raises(ValueError):  # bf16 pages where int8 codes belong
        paged_attention_quant(q, kp, k_s, v_q, v_s, table, lens)
    with pytest.raises(ValueError):  # float32 scales
        paged_attention_quant(q, k_q, k_s.float(), v_q, v_s, table, lens)
    shifted = torch.empty(k_q.numel() + 1, dtype=torch.int8, device=dev)[1:].view(k_q.shape)
    with pytest.raises(ValueError, match="16-byte"):  # a payload off its alignment
        paged_attention_quant(q, shifted, k_s, v_q, v_s, table, lens)
    x = torch.zeros((1, 8, 2, 48), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention(x, x, x)
    pages48 = torch.zeros((2, 16, 1, 48), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):  # no tensor-core tile for D 48
        paged_attention(x[:, 0, :1], pages48, pages48, table[:1], lens[:1])
    codes48 = torch.zeros((2, 16, 1, 48), device=dev, dtype=torch.int8)
    scales48 = torch.zeros((2, 16, 1), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention_quant(x[:, 0, :1], codes48, scales48, codes48, scales48, table[:1],
                              lens[:1])


def test_wrappers_refuse_autograd(dev):
    """The kernels write fresh outputs through ctypes, so their result has
    no ``grad_fn``: with grad enabled, an input that requires grad raises
    (the guard runs before the launch), and under ``no_grad`` the same call
    launches."""
    q, kp, vp, table, lens = _paged_inputs(dev, 2)
    (k_q, k_s), (v_q, v_s) = quantize_kv(kp), quantize_kv(vp)
    x = torch.randn((2, 32, 2, 64), device=dev, dtype=torch.bfloat16)
    calls = [
        (FLASH_KERNEL, lambda a: flash_attention(a, x, x, causal=False), x),
        (PAGED_KERNEL, lambda a: paged_attention(a, kp, vp, table, lens), q),
        (PAGED_QUANT_KERNEL, lambda a: paged_attention_quant(a, k_q, k_s, v_q, v_s, table,
                                                             lens), q),
    ]
    for kernel, call, arg in calls:
        before = kernel.launches
        with pytest.raises(RuntimeError, match="no backward"):
            call(arg.clone().requires_grad_(True))
        assert kernel.launches == before
        with torch.no_grad():
            call(arg.clone().requires_grad_(True))
        call(arg)
        assert kernel.launches == before + 2
    with pytest.raises(RuntimeError, match="no backward"):  # a pool that wants grad
        paged_attention(q, kp.clone().requires_grad_(True), vp, table, lens)


# the eval's paged engine: B 8, H 8, Hkv 4, D 64, 16-token pages, 128 pages
# a row; rows of 1, 17 and 2,048 keys among ragged others
EVAL_LENS = [0, 16, 2047, 5, 700, 1023, 1500, 31]


@pytest.mark.parametrize("quant", [False, True])
def test_paged_kernels_at_the_eval_engine_shape(dev, quant):
    """Both paged kernels at 16-token pages and D 64: a page is half of the
    kernels' 32-row chunk, the other half padding that must never be read
    (NaN K/V, or random codes and NaN scales, in every unowned slot)."""
    if quant:
        q, pools, table, lens = _quant_split_case(dev, EVAL_LENS, 2, 64, page=16, nb=128,
                                                  seed=16, hkv=4)
        out = paged_attention_quant(q, *pools, table, lens)
        torch.cuda.synchronize()
        _check_quant(q, pools, table, lens, out)
    else:
        q, kp, vp, table, lens = _split_case(dev, EVAL_LENS, 2, 64, page=16, nb=128, seed=16,
                                             hkv=4)
        out = paged_attention(q, kp, vp, table, lens)
        torch.cuda.synchronize()
        _check_paged(q, kp, vp, table, lens, out)
        assert (out.float() - paged_attention_plain(q.float(), kp.float(), vp.float(), table,
                                                    lens)).abs().mean().item() <= 2e-3


def test_training_step_on_the_card_matches_the_cpu(dev):
    """Two steps of ``train_encoder`` (step 0 at lr 0, step 1 at the peak
    lr) on the tiny encoder in bf16 compute from the same float32 masters,
    on the card and on the CPU: the losses agree within 5e-2 (bf16
    products summed in other orders) and the masters within 1e-3 (two Adam
    steps move an element by at most ~lr = 3e-4 each)."""
    from sentio_tpu_torch.eval.train_encoder import TrainConfig, param_leaves, train_encoder
    from sentio_tpu_torch.models.transformer import EncoderConfig, init_encoder

    cfg = EncoderConfig.tiny()
    tc = TrainConfig(steps=2, batch=8, warmup=1, d_len=128, n_docs=32, n_queries=16,
                     seeds=(7,))
    init = init_encoder(cfg, torch.Generator().manual_seed(0), "cpu", dtype=torch.float32)

    def copy(tree, device):
        return {k: copy(v, device) if isinstance(v, dict) else v.clone().to(device)
                for k, v in tree.items()}

    runs = {}
    for device in ("cpu", dev):
        params, _cfg, hist = train_encoder(enc_cfg=cfg, train_cfg=tc, log_every=1,
                                           device=device, params=copy(init, device))
        runs[str(torch.device(device).type)] = (params, [v for _i, v in hist["loss"]])
    (cpu_params, cpu_loss), (gpu_params, gpu_loss) = runs["cpu"], runs["cuda"]
    assert all(abs(a - b) <= 5e-2 for a, b in zip(cpu_loss, gpu_loss)), (cpu_loss, gpu_loss)

    moved = max((a - b.cpu()).abs().max().item() for a, b in zip(param_leaves(cpu_params),
                                                               param_leaves(gpu_params)))
    assert moved <= 1e-3, moved
    assert any(not torch.equal(a, b) for a, b in zip(param_leaves(cpu_params),
                                                     param_leaves(init)))


# ------------------------------------------------ the engine's CUDA graphs

# a small Llama whose head_dim (64) the paged kernels take
SMALL = LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2, mlp_dim=512,
                    max_len=512, rope_theta=10_000.0)
PROMPTS = ["graph replay check", "a second prompt that spans more than one page " * 2, "x"]


def _engine(dev, kv_quant="none", params=None, **kw):
    kw = dict(dict(max_slots=4, page_size=16, max_pages_per_seq=8, steps_per_tick=8), **kw)
    return ContinuousBatchingEngine(model_config=SMALL, params=params, device=dev,
                                    kv_quant=kv_quant, **kw)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_graph_ticks_match_eager_ticks(dev, kv_quant, depth):
    """Greedy tokens of graph-replayed ticks equal those of the same
    sub-step run eagerly on the card (same weights, same admissions), with
    the prefix cache on: the later prompts hit the earlier ones' pages."""
    graph = _engine(dev, kv_quant, pipeline_depth=depth)
    eager = _engine(dev, kv_quant, params=graph.params, pipeline_depth=depth)
    eager.cuda_graphs = False
    prompts = PROMPTS + [PROMPTS[1] + " again"]
    got, want = graph.run_all(prompts, 20), eager.run_all(prompts, 20)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert graph.prefix_hit_tokens_total == eager.prefix_hit_tokens_total
    assert graph.graph_captures == 1 and eager.graph_captures == eager.graph_replays == 0
    # every sub-step after the capture's warmup was a replay
    assert graph.graph_replays == graph.total_sub_steps - 1
    assert graph.total_sub_steps == eager.total_sub_steps + 1


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_moe_graph_ticks_match_eager_ticks(dev, kv_quant):
    """The MoE tick on the card (SMALL's attention, 8 experts, top-2, the
    no-drop cf 4): graph-replayed sub-steps give the eager sub-steps'
    greedy tokens and launch the pool's paged kernel once per layer per
    sub-step; the engine's routing tally counts every routed choice and no
    drop."""
    from sentio_tpu_torch.models.moe import MoeConfig

    cfg = MoeConfig(**{**SMALL.__dict__, "n_experts": 8, "experts_per_token": 2,
                       "capacity_factor": 4.0})
    kw = dict(max_slots=4, page_size=16, max_pages_per_seq=8, steps_per_tick=8,
              kv_quant=kv_quant)
    graph = ContinuousBatchingEngine(model_config=cfg, device=dev, **kw)
    eager = ContinuousBatchingEngine(model_config=cfg, params=graph.params, device=dev, **kw)
    eager.cuda_graphs = False
    kernel = PAGED_QUANT_KERNEL if kv_quant == "int8" else PAGED_KERNEL
    kernel.launches = 0
    got = graph.run_all(PROMPTS, 20)
    assert kernel.launches == cfg.n_layers * graph.total_sub_steps
    want = eager.run_all(PROMPTS, 20)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert graph.graph_replays == graph.total_sub_steps - 1
    torch.cuda.synchronize()
    stats = graph.stats()
    assert stats["moe_dropped"] == 0 and sum(stats["moe_routed"]) > 0


@pytest.mark.parametrize("path", ["decode", "spec"])
def test_moe_capture_past_the_grouped_size(dev, path):
    """A captured MoE decode sub-step (264 slots) or spec round (80 slots,
    k = 3: 320 verified tokens) routes more tokens than
    CAPACITY_DISPATCH_ROWS. Under capture it takes the capacity buffers
    (the grouped rows read counts on the host, which capture forbids) and
    gives the greedy tokens of the same ticks run eagerly, where those
    calls take the grouped rows. Float32 with plain attention, so that the
    two routes' rounding cannot flip a token."""
    import dataclasses

    from sentio_tpu_torch.models import moe
    from sentio_tpu_torch.runtime.paged import _paged_attn_xla

    cfg = moe.MoeConfig(**{**SMALL.__dict__, "n_experts": 8, "experts_per_token": 2,
                           "capacity_factor": 4.0, "dtype": "float32"})
    if path == "decode":
        kw, rows = dict(max_slots=264), 264
    else:
        draft = dataclasses.replace(DRAFT, dtype="float32")
        kw = dict(max_slots=80, draft_config=draft, spec_k=3, draft_params=moe.init_decoder(
            draft, torch.Generator(device=dev).manual_seed(9), dev))
        rows = 80 * 4
    assert rows > moe.CAPACITY_DISPATCH_ROWS
    kw.update(page_size=16, max_pages_per_seq=8, steps_per_tick=8, ignore_eos=True)
    graph = ContinuousBatchingEngine(model_config=cfg, device=dev, **kw)
    eager = ContinuousBatchingEngine(model_config=cfg, params=graph.params, device=dev, **kw)
    eager.cuda_graphs = False
    for engine in (graph, eager):
        engine.attn_impl = _paged_attn_xla
    got, want = graph.run_all(PROMPTS, 16), eager.run_all(PROMPTS, 16)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert graph.graph_captures == 1 and graph.graph_replays > 0
    assert eager.graph_captures == 0
    stats = graph.stats()
    assert stats["moe_dropped"] == 0 and sum(stats["moe_routed"]) > 0


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_launch_counts_through_replays(dev, kv_quant):
    """The paged kernel of the pool's type is counted once per layer per
    sub-step, replays and the warmup included (a capture itself launches
    nothing); the other paged kernel never. The card's own counts agree:
    each kernel's device-side count of its split kernel and its combine,
    and the profiler's count of each device function inside the replays."""
    from torch.profiler import ProfilerActivity, profile

    engine = _engine(dev, kv_quant)
    ran, other = ((PAGED_QUANT_KERNEL, PAGED_KERNEL) if kv_quant == "int8"
                  else (PAGED_KERNEL, PAGED_QUANT_KERNEL))
    ran.launches = other.launches = 0
    card0 = ran.device_launches(), other.device_launches()
    engine.run_all(PROMPTS[:1], 12)  # captures the greedy graph
    torch.cuda.synchronize()
    captured_steps = engine.total_sub_steps
    assert engine.graph_captures == 1
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.run_all(PROMPTS, 12)
        torch.cuda.synchronize()
    assert engine.graph_replays > 0
    assert ran.launches == SMALL.n_layers * engine.total_sub_steps
    assert other.launches == 0
    card = [tuple(n - n0 for n, n0 in zip(k.device_launches(), before))
            for k, before in zip((ran, other), card0)]
    assert card == [(ran.launches, ran.launches), (0, 0)]
    replayed = engine.total_sub_steps - captured_steps
    # no device function's name contains another's
    fns = ["paged_decode_kernel", "paged_combine_kernel",
           "paged_decode_int8_kernel", "paged_combine_int8_kernel"]
    device = {fn: sum(e.count for e in prof.key_averages() if fn in e.key) for fn in fns}
    ours, others = (fns[2:], fns[:2]) if kv_quant == "int8" else (fns[:2], fns[2:])
    assert device == {**dict.fromkeys(ours, SMALL.n_layers * replayed),
                      **dict.fromkeys(others, 0)}


@pytest.mark.parametrize("name", ["paged_attention", "paged_attention_quant", "flash_attention"])
def test_card_counts_each_launch(dev, name):
    """A kernel's device-side count (and its combine's) grows by one per
    launch: a direct call, and each replay of a CUDA graph holding the call,
    while the capture itself adds nothing."""
    q, kp, vp, table, lens = _paged_inputs(dev, 2)
    (k_q, k_s), (v_q, v_s) = quantize_kv(kp), quantize_kv(vp)
    x = torch.randn((2, 64, 2, 64), device=dev, dtype=torch.bfloat16)
    kernel, call, per_call = {
        "paged_attention": (PAGED_KERNEL, lambda: paged_attention(q, kp, vp, table, lens),
                            (1, 1)),
        "paged_attention_quant": (PAGED_QUANT_KERNEL, lambda: paged_attention_quant(
            q, k_q, k_s, v_q, v_s, table, lens), (1, 1)),
        "flash_attention": (FLASH_KERNEL, lambda: flash_attention(x, x, x), (1, 0)),
    }[name]

    def grown(before):
        torch.cuda.synchronize()
        return tuple(n - n0 for n, n0 in zip(kernel.device_launches(), before))

    before = kernel.device_launches()
    call()
    assert grown(before) == per_call
    before = kernel.device_launches()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        call()
    assert grown(before) == (0, 0)
    for _ in range(3):
        graph.replay()
    assert grown(before) == tuple(3 * n for n in per_call)


def test_capture_with_sampled_rows(dev):
    """A tick with sampled rows replays the sampled graph variants, which
    draw from the engine's own generator: a row at temperature 0.8 with
    top_k 1 must still give the greedy tokens, and one with top_k 5 valid
    tokens."""
    engine = _engine(dev)
    greedy = _engine(dev, params=engine.params)
    greedy.cuda_graphs = False
    ids = [engine.submit(PROMPTS[0], 12, 0.0), engine.submit(PROMPTS[0], 12, 0.8, top_k=1),
           engine.submit(PROMPTS[1], 12, 0.8, top_k=5)]
    done = {}
    while engine.has_work:
        for r in engine.step():
            done[r.request_id] = r
    # the same batch shapes, all greedy
    want = [r.tokens for r in greedy.run_all([PROMPTS[0], PROMPTS[0], PROMPTS[1]], 12)]
    assert done[ids[0]].tokens == want[0] and done[ids[1]].tokens == want[1]
    assert len(done[ids[2]].tokens) == 12 and max(done[ids[2]].tokens) < SMALL.vocab_size
    assert (False, True) in engine._graphs and engine.graph_replays > 0


# ------------------------------------- the contiguous engine and the service


@pytest.mark.parametrize("t,s", [(40, 96), (200, 384), (256, 512)])
def test_causal_flash_d128_over_a_cache_window(dev, t, s):
    """The contiguous engine's prefill: D 128, keys over the whole window
    (kv_lens None, S > T), the window's tail NaN (unwritten in the engine):
    the kernel reads none of it, with T a multiple of the query tile and
    not."""
    from sentio_tpu_torch.kernels import flash_attn_fn

    gen = torch.Generator(device=dev).manual_seed(t + s)
    b, h, d = 2, 4, 128
    q = torch.randn((b, t, h, d), generator=gen, device=dev, dtype=torch.bfloat16)
    k, v = (torch.randn((b, s, h, d), generator=gen, device=dev, dtype=torch.bfloat16)
            for _ in range(2))
    k[:, t:] = float("nan")
    v[:, t:] = float("nan")
    out = flash_attn_fn(q, k, v)
    torch.cuda.synchronize()
    ref = flash_attention_plain(q.float(), k.float(), v.float(), None, causal=True)
    diff = (out.float() - ref).abs()
    assert bool(out.isfinite().all())
    assert diff.max().item() <= ATOL and diff.mean().item() <= 2e-3


# head_dim 128, as Llama-3-8B's
WIDE_HEADS = LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
                         mlp_dim=512, max_len=1024, rope_theta=10_000.0)


def test_contiguous_engine_launches_flash_per_layer_per_prefill(dev):
    """GeneratorEngine on the card: each prefill launches the flash kernel
    once per layer (the card's own count agrees), decode never; ``stream``
    gives ``generate``'s greedy text."""
    from sentio_tpu_torch.config import GeneratorConfig
    from sentio_tpu_torch.runtime.engine import GeneratorEngine

    engine = GeneratorEngine(config=GeneratorConfig(max_new_tokens=8),
                             model_config=WIDE_HEADS, device=dev)
    FLASH_KERNEL.launches = 0
    card0 = FLASH_KERNEL.device_launches()[0]
    results = engine.generate(PROMPTS, max_new_tokens=8, temperature=0.0)
    results += engine.generate(PROMPTS[:1], max_new_tokens=8, temperature=0.0)
    torch.cuda.synchronize()
    assert engine.prefills == 2
    assert FLASH_KERNEL.launches == WIDE_HEADS.n_layers * engine.prefills
    assert FLASH_KERNEL.device_launches()[0] - card0 == FLASH_KERNEL.launches
    assert all(len(r.tokens) <= 8 for r in results)
    assert "".join(engine.stream(PROMPTS[0], max_new_tokens=8, temperature=0.0)) \
        == results[0].text


def test_no_capture_after_warmup(dev):
    """The service's warmup captures every graph variant; greedy, sampled
    and top-k traffic afterwards replays them and captures nothing."""
    from sentio_tpu_torch.runtime.service import PagedGenerationService

    engine = _engine(dev)
    service = PagedGenerationService(engine, default_timeout_s=120)
    try:
        stats = service.warmup()
        assert stats["graph_captures"] == len(engine.GRAPH_VARIANTS) == 3
        assert engine.graphs_frozen
        replays = engine.graph_replays
        for temperature, top_k in ((0.0, 0), (0.8, 0), (0.8, 5)):
            result = service.generate(PROMPTS[1], max_new_tokens=10,
                                      temperature=temperature, top_k=top_k)
            assert result.finish_reason in ("stop", "length")
        assert engine.graph_captures == 3 and engine.graph_replays > replays
    finally:
        service.close()


def test_forward_calls_need_no_stream_context(dev):
    """``prefill_forward`` and ``decode_forward`` called with no stream
    context run on the engine's stream (queued here behind a sleep there)
    and hand back logits the caller's stream can read at once: equal to the
    same calls made inside ``on_stream()`` and synchronized, with the
    caller's stream current again after."""
    import numpy as np

    engine = _engine(dev)
    n = 40
    width = engine._prefill_width(n)
    pages = engine.allocator.alloc(width // engine.page_size)
    ids = np.full((1, width), engine.tokenizer.pad_id, np.int64)
    ids[0, :n] = np.arange(n) % 200 + 10
    scat = np.asarray([pages], np.int64)
    row = torch.zeros((1, engine.max_pages_per_seq), dtype=torch.int32)
    row[0, :len(pages)] = torch.tensor(pages, dtype=torch.int32)

    def run():
        table = row.to(dev)
        out = [engine.prefill_forward(ids, np.asarray([n]), scat)]
        for s in range(3):
            lens = torch.tensor([n + s], dtype=torch.int32, device=dev)
            out.append(engine.decode_forward(out[-1].argmax(-1), lens, table))
        return torch.stack([x[0] for x in out])

    caller = torch.cuda.current_stream(dev)
    assert caller != engine.stream
    with torch.cuda.stream(engine.stream):
        torch.cuda._sleep(100_000_000)
    free = run().cpu()
    assert torch.cuda.current_stream(dev) == caller
    with engine.on_stream():
        ref = run()
    torch.cuda.synchronize()
    assert torch.isfinite(free).all() and torch.equal(free, ref.cpu())


def test_http_server_on_the_card(dev):
    """A 2-layer pipeline behind ``create_server`` on the card answers one
    JSON and one SSE ``/chat`` after warmup: both 200 and not degraded
    (no rerank fallback, no verifier error), the SSE stream ends with ``[DONE]``, each wrapper's count equals the
    card's own count of its device functions, and no graph is captured."""
    import http.client
    import json
    import tempfile
    import threading

    from sentio_tpu_torch.config import EmbedderConfig, GeneratorConfig, Settings
    from sentio_tpu_torch.infra.resilience import FallbackResponseCache, LLMFallback
    from sentio_tpu_torch.pipeline import build_pipeline
    from sentio_tpu_torch.serve.app import create_server

    settings = Settings(embedder=EmbedderConfig(model_preset="tiny"),
                        generator=GeneratorConfig(kv_page_size=16, kv_max_pages_per_seq=32,
                                                  max_new_tokens=12, verifier_max_tokens=12))
    pipeline = build_pipeline(settings, device=dev, llama_config=SMALL)
    pipeline.warmup()
    server = create_server(settings, pipeline, host="127.0.0.1", port=0,
                           fallback=(FallbackResponseCache(tempfile.mkdtemp()), LLMFallback()))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def post(path, payload):
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=120)
        try:
            conn.request("POST", path, body=json.dumps(payload),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, resp.read().decode()
        finally:
            conn.close()

    try:
        assert post("/embed", {"content": " ".join(PROMPTS) * 4})[0] == 200
        engine = pipeline.service.engine
        captures = engine.graph_captures
        kernels = {"paged": PAGED_KERNEL, "quant": PAGED_QUANT_KERNEL, "flash": FLASH_KERNEL}
        torch.cuda.synchronize()
        card0 = {k: kernel.device_launches() for k, kernel in kernels.items()}
        for kernel in kernels.values():
            kernel.launches = 0
        status, body = post("/chat", {"question": PROMPTS[1]})
        meta = json.loads(body)["metadata"]
        assert status == 200 and meta["degraded"] is False and not meta.get("rerank_fallback")
        assert not any(n.startswith("verifier error") for n in meta["evaluation"]["notes"])
        status, body = post("/chat", {"question": PROMPTS[0], "stream": True})
        assert status == 200 and '"token"' in body and body.rstrip().endswith("data: [DONE]")
        assert '"verdict"' in body and "rerank_fallback" not in body \
            and "verifier error" not in body
        pipeline.service.wait_idle()
        torch.cuda.synchronize()
        for name, kernel in kernels.items():
            card = [n - n0 for n, n0 in zip(kernel.device_launches(), card0[name])]
            assert card[0] == kernel.launches, name
        assert PAGED_KERNEL.launches > 0 and FLASH_KERNEL.launches > 0
        assert PAGED_QUANT_KERNEL.launches == 0
        assert engine.graph_captures == captures
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        pipeline.close()


# ------------------------------------------------------------- speculation

DRAFT = LlamaConfig(vocab_size=512, dim=128, n_layers=1, n_heads=2, n_kv_heads=1, mlp_dim=256,
                    max_len=512, rope_theta=10_000.0)


def _spec_engine(dev, params=None, draft_params=None, **kw):
    from sentio_tpu_torch.models.llama import init_llama

    if draft_params is None:
        draft_params = init_llama(DRAFT, torch.Generator(device=dev).manual_seed(9), dev)
    return _engine(dev, params=params, draft_params=draft_params, draft_config=DRAFT, spec_k=3,
                   **kw)


@pytest.mark.parametrize("depth", [1, 2])
def test_spec_round_graph_matches_eager_round(dev, depth):
    """Spec ticks whose rounds replay a CUDA graph give the tokens of the
    same rounds run eagerly on the card (same weights and admissions),
    greedy and with a sampled row beside greedy ones; the paged kernels
    never launch."""
    graph = _spec_engine(dev, pipeline_depth=depth, ignore_eos=True)
    eager = _spec_engine(dev, params=graph.params, draft_params=graph.draft_params,
                         pipeline_depth=depth, ignore_eos=True)
    eager.cuda_graphs = False
    PAGED_KERNEL.launches = PAGED_QUANT_KERNEL.launches = 0
    prompts = PROMPTS + [PROMPTS[1] + " again"]
    got, want = graph.run_all(prompts, 20), eager.run_all(prompts, 20)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert (graph.spec_verifies_total, graph.spec_emitted_total) == \
        (eager.spec_verifies_total, eager.spec_emitted_total)
    assert graph.graph_captures == 1 and graph.graph_replays == graph.spec_rounds_total
    assert eager.graph_captures == eager.graph_replays == 0
    assert PAGED_KERNEL.launches == PAGED_QUANT_KERNEL.launches == 0
    # a sampled row rides the sampled variant and still ends its budget
    ids = [graph.submit(PROMPTS[0], 12, 0.0), graph.submit(PROMPTS[2], 12, 0.8)]
    done = {}
    while graph.has_work:
        for r in graph.step():
            done[r.request_id] = r
    assert [len(done[i].tokens) for i in ids] == [12, 12]
    assert ("spec", False) in graph._graphs and graph.graph_captures == 2


def test_spec_capture_after_warmup_raises(dev):
    """The service's warmup captures both spec round variants (no top-k
    request: a draft refuses top-k); traffic then replays them, and a tick
    that would capture a round afterwards raises."""
    from sentio_tpu_torch.runtime.service import PagedGenerationService

    engine = _spec_engine(dev)
    service = PagedGenerationService(engine, default_timeout_s=120)
    try:
        stats = service.warmup()
        assert stats["graph_captures"] == len(engine.graph_variants) == 2
        assert engine.graphs_frozen and set(engine._graphs) == set(engine.SPEC_GRAPH_VARIANTS)
        replays = engine.graph_replays
        for temperature in (0.0, 0.8):
            result = service.generate(PROMPTS[1], max_new_tokens=10, temperature=temperature)
            assert result.finish_reason in ("stop", "length")
        assert engine.graph_captures == 2 and engine.graph_replays > replays
        service.wait_idle()
        del engine._graphs[("spec", False)]
        engine.submit(PROMPTS[0], 8, 0.8)
        with pytest.raises(RuntimeError, match="warmup did not capture"):
            while engine.has_work:
                engine.step()
    finally:
        service.close()


def test_contiguous_spec_prefills_launch_flash(dev):
    """The contiguous SpeculativeDecoder prefills the target and the draft
    through the flash kernel: one launch per layer each, the card's count
    the same."""
    from sentio_tpu_torch.config import GeneratorConfig
    from sentio_tpu_torch.models.llama import init_llama
    from sentio_tpu_torch.runtime.engine import GeneratorEngine
    from sentio_tpu_torch.runtime.speculative import SpeculativeDecoder

    engine = GeneratorEngine(config=GeneratorConfig(max_new_tokens=8),
                             model_config=WIDE_HEADS, device=dev)
    draft = init_llama(WIDE_HEADS, torch.Generator(device=dev).manual_seed(3), dev)
    spec = SpeculativeDecoder(engine, draft, WIDE_HEADS, k=3)
    FLASH_KERNEL.launches = 0
    card0 = FLASH_KERNEL.device_launches()[0]
    got = spec.generate(PROMPTS, max_new_tokens=8)
    torch.cuda.synchronize()
    assert spec.prefills == 2 and spec.stats["rounds"] > 0
    assert FLASH_KERNEL.launches == 2 * WIDE_HEADS.n_layers
    assert FLASH_KERNEL.device_launches()[0] - card0 == FLASH_KERNEL.launches
    assert all(len(g.tokens) <= 8 for g in got)


def test_two_worker_process_set_on_the_card(dev):
    """``REPLICA_MODE=process`` on the card at small width: two workers on
    the router's weight tensors (CUDA IPC through the spawn arguments).
    Each worker's rise in the card's used memory at its spawn, less its
    own reserved memory, is under the weights' bytes plus a CUDA context
    (a private copy would be in one or the other: here the weights are
    made larger than the pool); its paged launches equal its card counts;
    the greedy tokens equal a thread-mode engine's on the same weights."""
    import dataclasses
    import multiprocessing

    from sentio_tpu_torch.kernels import KERNELS
    from sentio_tpu_torch.kernels._build import build_all
    from sentio_tpu_torch.models.llama import init_llama
    from sentio_tpu_torch.models.tokenizer import ByteTokenizer
    from sentio_tpu_torch.runtime.replica import ReplicaSet
    from sentio_tpu_torch.runtime.service import PagedGenerationService
    from sentio_tpu_torch.runtime.worker import ProcessReplica, WorkerSpec

    cfg = LlamaConfig(vocab_size=32_000, dim=2048, n_layers=4, n_heads=16, n_kv_heads=8,
                      mlp_dim=5632, max_len=2048)
    params = init_llama(cfg, torch.Generator(device=dev).manual_seed(4), dev)
    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        return tree.numel() * tree.element_size()

    weight_bytes = nbytes(params)
    engine_kw = dict(max_slots=4, page_size=128, max_pages_per_seq=4, steps_per_tick=8)
    build_all(KERNELS)
    spec = WorkerSpec(factory_kwargs=dict(
        params=params, model_config=dataclasses.asdict(cfg), device="cuda",
        engine_kwargs=engine_kw), telemetry_interval_s=0)
    rises, services = [], []
    try:
        for i in range(2):
            free0, total = torch.cuda.mem_get_info()
            services.append(ProcessReplica(spec, ByteTokenizer(cfg.vocab_size), replica_id=i,
                                           build_timeout_s=300))
            free1, _ = torch.cuda.mem_get_info()
            reserved = services[-1].ready_info["worker"]["memory"]["reserved"]
            rises.append((free0 - free1, reserved))
        rs = ReplicaSet(services, supervise=False)
        try:
            rs.warmup()
            before = [svc.stats()["worker"] for svc in rs.services]
            got = [rs.services[i].generate(PROMPTS[1], max_new_tokens=16).tokens
                   for i in range(2)]
            after = [svc.stats() for svc in rs.services]
        finally:
            rs.close()
    finally:
        for svc in services:
            svc.close()
    for rise, reserved in rises:
        assert reserved < weight_bytes and rise - reserved < 2 << 30, (rise, reserved)
    for b, a in zip(before, after):
        w = a["worker"]
        n = w["launches"]["paged_attention"] - b["launches"]["paged_attention"]
        card = [x - y for x, y in zip(w["device_launches"]["paged_attention"],
                                      b["device_launches"]["paged_attention"])]
        assert n > 0 and card == [n, n] and w["foreign_modules"] == []
    local = PagedGenerationService(ContinuousBatchingEngine(model_config=cfg, params=params,
                                                            device=dev, **engine_kw))
    try:
        want = local.generate(PROMPTS[1], max_new_tokens=16).tokens
    finally:
        local.close()
    assert got == [want, want]
    assert multiprocessing.active_children() == []


def test_scorer_embed_on_the_card_matches_plain(dev, monkeypatch):
    """The post-fusion scorers' one batched embedding of the query and the
    candidates runs the flash kernel once a layer on the card, and its
    vectors and the semantic and MMR scores equal those of the same
    embedder with plain attention."""
    import numpy as np

    from sentio_tpu_torch.config import EmbedderConfig
    from sentio_tpu_torch.models.document import Document
    from sentio_tpu_torch.models.transformer import EncoderConfig
    from sentio_tpu_torch.ops import embedder as embedder_module
    from sentio_tpu_torch.ops import scorers

    cfg = EncoderConfig(vocab_size=512, dim=256, n_layers=3, n_heads=4, mlp_dim=512,
                        max_len=512)
    emb = embedder_module.TorchEmbedder(EmbedderConfig(cache_size=0, coalesce=False),
                                        model_config=cfg, device=dev)
    docs = [Document(text=f"candidate {i}: " + "pages hold keys and values " * (i + 1),
                     id=f"c{i}") for i in range(12)]
    question = "what do the pages hold?"

    def run():
        scorers._EMBED_MEMO.entry = None
        vecs = scorers._doc_embeddings(emb, question, docs)
        return (vecs, scorers.SemanticSimilarityScorer(embedder=emb).score(question, docs),
                scorers.MMRScorer(embedder=emb).score(question, docs))

    before = FLASH_KERNEL.launches
    (q, mat), sem, mmr = run()
    assert FLASH_KERNEL.launches - before == cfg.n_layers  # one forward, memo shared
    monkeypatch.setattr(emb, "attn_fn", lambda q, k, v, kv_lens=None: flash_attention_plain(
        q, k, v, kv_lens, causal=False))
    before = FLASH_KERNEL.launches
    (pq, pmat), psem, pmmr = run()
    assert FLASH_KERNEL.launches == before
    np.testing.assert_allclose(q, pq, atol=2e-2, rtol=0)
    np.testing.assert_allclose(mat, pmat, atol=2e-2, rtol=0)
    np.testing.assert_allclose(sem, psem, atol=1e-2, rtol=0)
    assert mat.shape == (12, cfg.dim) and sem.shape == mmr.shape == (12,)


# ------------------------------------------------- a tp=2 mesh on the one card


def _tp2_mesh(dev):
    from sentio_tpu_torch.config import MeshConfig
    from sentio_tpu_torch.parallel.mesh import build_mesh

    return build_mesh(MeshConfig(dp_size=1, tp_size=2), devices=[dev, dev])


@pytest.mark.parametrize("kernel", ["paged", "paged_int8", "flash_bidirectional",
                                    "flash_causal_prefill"])
def test_kernels_at_a_tp2_shards_shape(dev, kernel):
    """Each kernel at the shape one tp=2 shard of the main path gives it
    (Llama-3-8B's decode: H 16, Hkv 4, D 128, 128-token pages; the base
    embedder: H 8, D 64; the 8B prefill: H 16, D 128 over a cache window)
    against its plain version, max abs 2e-2, mean 2e-3."""
    if kernel.startswith("paged"):
        lens = [0, 5, 127, 128, 1000, 1023]
        q, kp, vp, table, lens_t = _split_case(dev, lens, rep=4, d=128, page=128, nb=8,
                                               seed=3, hkv=4)
        if kernel == "paged":
            out = paged_attention(q, kp, vp, table, lens_t)
            torch.cuda.synchronize()
            _check_paged(q, kp, vp, table, lens_t, out)
            return
        q, pools, table, lens_t = _quant_split_case(dev, lens, rep=4, d=128, page=128, nb=8,
                                                    seed=3, hkv=4)
        out = paged_attention_quant(q, *pools, table, lens_t)
        torch.cuda.synchronize()
        _check_quant(q, pools, table, lens_t, out)
        return
    causal = kernel == "flash_causal_prefill"
    b, t, s, h, d = (1, 512, 1024, 16, 128) if causal else (8, 512, 512, 8, 64)
    gen = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn((b, t, h, d), generator=gen, device=dev, dtype=torch.bfloat16)
    k, v = (torch.randn((b, s, h, d), generator=gen, device=dev, dtype=torch.bfloat16)
            for _ in range(2))
    lens = None if causal else torch.tensor([512, 0, 1, 64, 300, 512, 129, 17],
                                            dtype=torch.int32, device=dev)
    if causal:
        k[:, t:] = float("nan")  # the window's unwritten tail: never read
        v[:, t:] = float("nan")
    out = flash_attention(q, k, v, lens, causal=causal)
    torch.cuda.synchronize()
    ref = flash_attention_plain(q.float(), k.float(), v.float(), lens, causal=causal)
    diff = (out.float() - ref).abs()
    assert bool(out.isfinite().all())
    assert diff.max().item() <= ATOL and diff.mean().item() <= 2e-3


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_tp2_engine_on_one_card(dev, kv_quant):
    """A tp=2 mesh of the one card: each sampling variant one CUDA graph
    over both shards, the pool's kernel launched once per layer per shard
    per sub-step (the card's counts agree), greedy tokens equal to the same
    tp=2 sub-step run eagerly."""
    mesh = _tp2_mesh(dev)
    graph = _engine(dev, kv_quant, mesh=mesh)
    eager = _engine(dev, kv_quant, params=graph.sharded, mesh=mesh)
    eager.cuda_graphs = False
    assert graph.tp == 2 and graph.cuda_graphs
    assert all(p.k.is_contiguous() if kv_quant == "none" else p.k.q.is_contiguous()
               for p in graph.pool.shards)
    ran = PAGED_QUANT_KERNEL if kv_quant == "int8" else PAGED_KERNEL
    graph.run_all(PROMPTS[:1], 4)  # captures the greedy graph
    torch.cuda.synchronize()
    ran.launches = 0
    card0 = ran.device_launches()
    steps0 = graph.total_sub_steps
    got = graph.run_all(PROMPTS, 16)
    torch.cuda.synchronize()
    steps = graph.total_sub_steps - steps0
    assert graph.graph_replays > 0 and graph.graph_captures == 1
    assert ran.launches == 2 * SMALL.n_layers * steps
    assert tuple(n - n0 for n, n0 in zip(ran.device_launches(), card0)) == (ran.launches,) * 2
    eager.run_all(PROMPTS[:1], 4)
    want = eager.run_all(PROMPTS, 16)
    assert [r.tokens for r in got] == [r.tokens for r in want]


def test_tp2_contiguous_and_encoders_launch_flash_per_shard(dev):
    """On a tp=2 mesh of the card the contiguous engine's prefill launches
    the causal flash kernel once per layer per shard, the embedder's
    forward the bidirectional one likewise; the embedder's vectors agree
    with one device's within the bf16 tolerance."""
    from sentio_tpu_torch.config import EmbedderConfig, GeneratorConfig
    from sentio_tpu_torch.ops.embedder import TorchEmbedder
    from sentio_tpu_torch.runtime.engine import GeneratorEngine

    mesh = _tp2_mesh(dev)
    engine = GeneratorEngine(config=GeneratorConfig(model_preset="tiny", max_new_tokens=4),
                             model_config=SMALL, mesh=mesh)
    FLASH_KERNEL.launches = 0
    engine.generate(PROMPTS[:2], max_new_tokens=4, temperature=0.0)
    torch.cuda.synchronize()
    assert FLASH_KERNEL.launches == 2 * SMALL.n_layers * engine.prefills
    cfg = EmbedderConfig(model_preset="tiny", coalesce=False, cache_size=0)
    one = TorchEmbedder(cfg, device=dev)
    two = TorchEmbedder(cfg, params=one.params, model_config=one.model_config, mesh=mesh)
    FLASH_KERNEL.launches = 0
    got = two.embed_many(PROMPTS)
    assert FLASH_KERNEL.launches == 2 * one.model_config.n_layers
    assert abs(got - one.embed_many(PROMPTS)).max() <= ATOL


def _mesh(dev, **fields):
    from sentio_tpu_torch.config import MeshConfig
    from sentio_tpu_torch.parallel.mesh import build_mesh

    n = 1
    for v in fields.values():
        n *= v
    return build_mesh(MeshConfig(**fields), devices=[dev] * n)


def test_mesh_attn_fn_on_the_card(dev):
    """``make_mesh_attn_fn``: at sp 1 each tp shard launches the flash
    kernel on its heads (the card counts one launch a shard); at sp 2 the
    ring (plain products) launches none; both against plain attention."""
    from sentio_tpu_torch.kernels import make_mesh_attn_fn
    from sentio_tpu_torch.models import layers as L

    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn((2, 256, 8, 64), generator=gen, device=dev, dtype=torch.bfloat16)
               for _ in range(3))
    ref = L.attention(q.float(), k.float(), v.float(), L.causal_mask(256, device=dev),
                      torch.float32)
    FLASH_KERNEL.launches = 0
    card0 = FLASH_KERNEL.device_launches()
    flash = make_mesh_attn_fn(_mesh(dev, dp_size=2, tp_size=2))(q, k, v)
    torch.cuda.synchronize()
    assert FLASH_KERNEL.launches == 4  # 2 dp rows × 2 tp shards
    assert FLASH_KERNEL.device_launches()[0] - card0[0] == 4
    ring = make_mesh_attn_fn(_mesh(dev, sp_size=2, tp_size=2))(q, k, v)
    torch.cuda.synchronize()
    assert FLASH_KERNEL.launches == 4
    for out in (flash, ring):
        assert (out.float() - ref).abs().max().item() <= ATOL


def test_ep_tp_moe_engine_on_one_card(dev):
    """A MoE model on ep=2 × tp=2 of the card: each decode sub-step one CUDA
    graph over every shard, the paged kernel launched once a layer a tp
    shard a sub-step (= the card's counts), greedy tokens equal to the
    same sub-step run eagerly and to one device's."""
    from sentio_tpu_torch.models.moe import MoeConfig, init_moe

    cfg = MoeConfig(vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                    mlp_dim=256, max_len=512, rope_theta=10_000.0, n_experts=4,
                    experts_per_token=2, capacity_factor=2.0)
    params = init_moe(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    mesh = _mesh(dev, ep_size=2, tp_size=2)
    kw = dict(max_slots=4, page_size=16, max_pages_per_seq=8, steps_per_tick=8, device=dev)
    graph = ContinuousBatchingEngine(model_config=cfg, params=params, mesh=mesh, **kw)
    eager = ContinuousBatchingEngine(model_config=cfg, params=graph.sharded, mesh=mesh, **kw)
    eager.cuda_graphs = False
    assert graph.tp == 2 and len(graph.params.experts) == 2 and graph.cuda_graphs
    graph.run_all(PROMPTS[:1], 4)
    torch.cuda.synchronize()
    PAGED_KERNEL.launches = 0
    card0 = PAGED_KERNEL.device_launches()
    steps0 = graph.total_sub_steps
    got = graph.run_all(PROMPTS, 16)
    torch.cuda.synchronize()
    steps = graph.total_sub_steps - steps0
    assert graph.graph_replays > 0 and graph.graph_captures == 1
    assert PAGED_KERNEL.launches == 2 * cfg.n_layers * steps
    assert tuple(n - n0 for n, n0 in zip(PAGED_KERNEL.device_launches(), card0)) == \
        (PAGED_KERNEL.launches,) * 2
    eager.run_all(PROMPTS[:1], 4)
    assert [r.tokens for r in eager.run_all(PROMPTS, 16)] == [r.tokens for r in got]


def test_train_steps_on_the_card_launch_no_kernel(dev):
    """``llama_loss`` on dp=2 × tp=2 and ``pipeline_loss`` on pp=2 × tp=2 of
    the card, forward and backward, launch none of the three kernels; a
    kernel under autograd refuses (its result would train nothing)."""
    import dataclasses

    from sentio_tpu_torch.kernels import KERNELS, flash_attn_fn
    from sentio_tpu_torch.models.llama import init_llama, llama_forward, llama_loss
    from sentio_tpu_torch.models.llama import stack_layer_params
    from sentio_tpu_torch.parallel.pipeline import pipeline_loss, shard_stacked_params
    from sentio_tpu_torch.parallel.sharding import LLAMA_TP_RULES, shard_params

    cfg = LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                      mlp_dim=512, max_len=512, rope_theta=10_000.0, dtype="float32")
    params = init_llama(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    ids = torch.randint(1, 512, (4, 65), generator=gen, device=dev)
    mask = torch.ones((4, 65), dtype=torch.bool, device=dev)
    sharded = shard_params(params, _mesh(dev, dp_size=2, tp_size=2), LLAMA_TP_RULES)
    stacked = shard_stacked_params(stack_layer_params(params, cfg), _mesh(dev, pp_size=2,
                                                                          tp_size=2))
    for tree in (sharded, stacked):
        for t in tree.parameters():
            t.requires_grad_(True)
    before = [(k.launches, k.device_launches()) for k in KERNELS]
    ref = llama_loss(sharded, cfg, ids, mask)
    ref.backward()
    got = pipeline_loss(stacked, cfg, ids, mask, n_micro=2)
    got.backward()
    torch.cuda.synchronize()
    assert [(k.launches, k.device_launches()) for k in KERNELS] == before
    assert abs(got.item() - ref.item()) <= 1e-4 * abs(ref.item())
    leaf = params["layers_0"]["attn"]["wq"]["weight"].detach().requires_grad_(True)
    tree = dict(params, layers_0=dict(params["layers_0"], attn=dict(
        params["layers_0"]["attn"], wq={"weight": leaf})))
    with pytest.raises(RuntimeError, match="no backward"):
        llama_forward(tree, dataclasses.replace(cfg, dtype="bfloat16"), ids[:, :64],
                      attn_fn=flash_attn_fn)


def test_a_device_named_twice_holds_copies_of_its_own(dev):
    """A mesh that names the card ``cuda:0`` and ``cuda`` along dp holds
    each dp group's slices in storage of their own, as two cards would: an
    optimizer steps each copy once, and after the gradient sum over copies
    they stay bit-equal."""
    from sentio_tpu_torch.models.llama import init_llama, llama_loss
    from sentio_tpu_torch.parallel.collectives import psum_replicated_grads
    from sentio_tpu_torch.parallel.mesh import MESH_AXES, Mesh
    from sentio_tpu_torch.parallel.sharding import LLAMA_TP_RULES, shard_params

    cfg = LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                      mlp_dim=512, max_len=512, rope_theta=10_000.0, dtype="float32")
    grid = _mesh(dev, dp_size=2, tp_size=2).devices.copy()
    grid[:, 1:] = torch.device("cuda")
    sharded = shard_params(init_llama(cfg, torch.Generator(device=dev).manual_seed(0), dev),
                           Mesh(grid, MESH_AXES), LLAMA_TP_RULES)
    copies = sharded.copies()
    assert copies and all(len({t.data_ptr() for t in group}) == len(group) for group in copies)
    tensors = sharded.parameters()
    for t in tensors:
        t.requires_grad_(True)
    gen = torch.Generator(device=dev).manual_seed(1)
    ids = torch.randint(1, 512, (4, 65), generator=gen, device=dev)
    llama_loss(sharded, cfg, ids, torch.ones_like(ids, dtype=torch.bool)).backward()
    psum_replicated_grads(copies)
    torch.optim.AdamW(tensors, lr=1e-3, weight_decay=1e-4).step()
    assert all(torch.equal(group[0], t) for group in copies for t in group[1:])
