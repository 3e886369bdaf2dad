"""The port on a CUDA card: each CUDA kernel against its plain PyTorch
version, one RAG query batch through both retrieval kernel paths against
the exact integer path, a short paged `query_stream` through K3, a
4-macro sharded search on the card against the same index on the CPU,
and the ssm / hybrid / audio models and the slot-resident engine on the
card against the CPU. No
JAX here, so the file runs on a machine with a card and PyTorch only:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card every test skips."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import bitplane, topk  # noqa: E402
from repro_torch.core.quantization import int_norm  # noqa: E402
from repro_torch.core.retrieval import DircRagIndex, RetrievalConfig  # noqa: E402
from repro_torch.core.sharded_index import ShardedDircIndex  # noqa: E402
from repro_torch.kernels import (_build, dirc_mac, ops, paged_attend,  # noqa: E402
                                 score_matmul, topk_select)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.serving import (EngineConfig, GenerationTicket,  # noqa: E402
                                 HashEmbedder, RagPipeline)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _codes(g, shape, bits, dev):
    lo = -(1 << (bits - 1))
    return torch.randint(lo, -lo, shape, generator=g, device=dev, dtype=torch.int8)


@pytest.mark.parametrize("b,n,dim,bits", [(1, 8192, 512, 8), (16, 8229, 1024, 4),
                                          (3, 300, 128, 8), (17, 129, 256, 8)])
def test_kernels_match_plain(dev, b, n, dim, bits):
    """Bit-equal int32 outputs; one launch counted per kernel call."""
    g = torch.Generator(device=dev).manual_seed(0)
    q, d = _codes(g, (b, dim), bits, dev), _codes(g, (n, dim), bits, dev)
    before = (dirc_mac.LAUNCHES, score_matmul.LAUNCHES)
    got2 = score_matmul.score_matmul_int(q, d)
    qp = bitplane.pack_words(bitplane.to_bitplanes(q, bits))
    dp = bitplane.pack_words(bitplane.to_bitplanes(d, bits)).permute(1, 2, 0).contiguous()
    got1 = dirc_mac.dirc_mac_packed(qp, dp, bits)
    torch.cuda.synchronize()
    assert torch.equal(got2, score_matmul.score_matmul_int_ref(q, d))
    assert torch.equal(got1, dirc_mac.dirc_mac_packed_ref(qp, dp, bits))
    assert torch.equal(got1, got2)
    assert (dirc_mac.LAUNCHES, score_matmul.LAUNCHES) == (before[0] + 1, before[1] + 1)
    packed = bitplane.pack_words(bitplane.to_bitplanes(d, bits))
    assert torch.equal(ops.dirc_mac(q[0], packed, bits), got2[0])


@pytest.mark.parametrize("b,n,dim,bits", [(3, 8229, 512, 8), (72, 16384, 1024, 4),
                                          (72, 300, 128, 8), (3, 16384, 256, 4)])
def test_k1_random_plane_words(dev, b, n, dim, bits):
    """K1 on plane words that no codes built (sensed flips give any
    pattern): bit-equal to its plain version, the popcount identity."""
    g = torch.Generator(device=dev).manual_seed(b + n + bits)
    qp = torch.randint(-2**31, 2**31, (b, bits, dim // 32), generator=g, device=dev,
                       dtype=torch.int32)
    dp = torch.randint(-2**31, 2**31, (bits, dim // 32, n), generator=g, device=dev,
                       dtype=torch.int32)
    before = dirc_mac.LAUNCHES
    got = dirc_mac.dirc_mac_packed(qp, dp, bits)
    want = dirc_mac.dirc_mac_packed_ref(qp, dp, bits)
    torch.cuda.synchronize()
    assert dirc_mac.LAUNCHES == before + 1
    assert torch.equal(got, want)


def test_kernels_refuse_what_they_do_not_take(dev):
    q = torch.zeros((2, 40), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="dim % 16"):
        score_matmul.score_matmul_int(q, torch.zeros((5, 40), dtype=torch.int8, device=dev))
    with pytest.raises(ValueError, match="CUDA device"):
        score_matmul.score_matmul_int(q[:, :32].contiguous(),
                                      torch.zeros((5, 32), dtype=torch.int8))
    qp = torch.zeros((1, 8, 100), dtype=torch.int32, device=dev)    # nw > 96
    with pytest.raises(RuntimeError, match="CUDA error"):
        dirc_mac.dirc_mac_packed(qp, torch.zeros((8, 100, 5), dtype=torch.int32,
                                                 device=dev), 8)


@pytest.mark.parametrize("path", ["kernel_bitserial", "kernel_mxu"])
def test_rag_query_on_the_card(dev, path):
    """Smoke model, 512 docs: both kernel paths return the ids and scores of
    the exact integer path and launch their kernel."""
    rng = np.random.default_rng(0)
    corpus = [f"document {i}: " + " ".join(f"w{rng.integers(0, 997)}" for _ in range(12))
              for i in range(512)]
    cfg = get_config("phi4-mini-3.8b", smoke=True)
    model = build_model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    base = RetrievalConfig(bits=8, metric="cosine", n_cores=16)
    pipe = RagPipeline(corpus, dataclasses.replace(base, path=path), model=model,
                       embedder=HashEmbedder(dim=128), dim=128, device=dev)
    exact = DircRagIndex.build(pipe.embedder.embed(corpus),
                               dataclasses.replace(base, path="int_exact"), device=dev)
    queries = corpus[:4]
    want = exact.search(pipe.embedder.embed(queries), 3)
    dirc_mac.LAUNCHES = score_matmul.LAUNCHES = 0
    res = pipe.query_many(queries, k=3, max_new_tokens=4)
    kmod = dirc_mac if path == "kernel_bitserial" else score_matmul
    assert kmod.LAUNCHES == 1
    np.testing.assert_array_equal(np.stack([r.doc_ids for r in res]),
                                  want.indices.cpu().numpy())
    np.testing.assert_array_equal(np.stack([r.doc_scores for r in res]),
                                  want.scores.cpu().numpy())
    assert [int(r.doc_ids[0]) for r in res] == [0, 1, 2, 3]
    assert all(r.answer_tokens.shape == (1, 4) for r in res)


def _k3_case(dev, dtype, lengths, n_valid, t, mb, bs=16, h=24, kh=8, hd=128,
             tables=None, poison=False, poison_new=False, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    b = len(lengths)
    n_blocks = b * mb + 2

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    kp, vp = rnd(n_blocks, bs, kh, hd), rnd(n_blocks, bs, kh, hd)
    if poison:
        kp[0], vp[0] = 1e4, -1e4
    if tables is None:
        tables = torch.zeros((b, mb), dtype=torch.int32)
        for r in range(b):
            need = min(-(-(lengths[r] + t) // bs), mb)
            tables[r, :need] = torch.arange(1 + r * mb, 1 + r * mb + need)
    if poison_new:   # the cells the new tokens take: K3 must score k_new / v_new
        for r in range(b):
            for p in range(lengths[r], lengths[r] + n_valid[r]):
                blk = int(tables[r][p // bs])
                kp[blk, p % bs], vp[blk, p % bs] = 1e4, -1e4
    return [rnd(b, t, h, hd), rnd(b, t, kh, hd), rnd(b, t, kh, hd), kp, vp,
            torch.as_tensor(tables, dtype=torch.int32).to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev),
            torch.tensor(n_valid, dtype=torch.int32, device=dev)]


_COW = [[1, 5, 6, 0, 0, 0], [1, 2, 7, 0, 0, 0]]
_K3_CASES = {
    "decode": dict(lengths=[287, 5, 0, 511], n_valid=[1, 1, 0, 1], t=1, mb=33),
    "prefill": dict(lengths=[250], n_valid=[27], t=32, mb=33),
    "prefill_from_0": dict(lengths=[0], n_valid=[32], t=32, mb=33),
    "cow": dict(lengths=[18, 32], n_valid=[30, 1], t=32, mb=6, tables=_COW),
    "null_poison": dict(lengths=[5, 200], n_valid=[1, 1], t=1, mb=33, poison=True),
    "new_tokens_poisoned": dict(lengths=[250, 7], n_valid=[27, 32], t=32, mb=33,
                                poison_new=True),
    "prefill_b16_mixed": dict(lengths=[0, 500, 17, 255, 256, 129, 31, 400, 1, 64, 96, 333,
                                       127, 480, 12, 200],
                              n_valid=[32, 32, 0, 1, 17, 32, 5, 28, 32, 3, 32, 9, 1, 20, 32,
                                       16], t=32, mb=34),
    # head dims other than phi4-mini's 128 (any multiple of 16 for bf16)
    "prefill_hd96": dict(lengths=[250, 0], n_valid=[27, 32], t=32, mb=33, hd=96),
    "decode_hd80": dict(lengths=[287, 40, 128], n_valid=[1, 1, 1], t=1, mb=33, hd=80,
                        h=32, kh=32),
    # the DecoderLM families' head layouts: g 4 (phi3.5-moe, phi3-medium), 8
    # (qwen2-vl, arctic's padded 64 heads), 12 (command-r), 48 over one KV
    # head (granite's MQA); a 32-token piece at g 48 is 1,536 query rows
    "g4_decode_b8": dict(lengths=[287, 300, 5, 0, 511, 128, 33, 270],
                         n_valid=[1, 1, 1, 0, 1, 1, 1, 1], t=1, mb=33, h=32, kh=8),
    "g4_prefill": dict(lengths=[250], n_valid=[27], t=32, mb=33, h=40, kh=10),
    "g8_decode": dict(lengths=[287, 16, 127], n_valid=[1, 1, 1], t=1, mb=33, h=64, kh=8),
    "g8_prefill": dict(lengths=[96, 0], n_valid=[32, 19], t=32, mb=33, h=64, kh=8),
    "g12_decode": dict(lengths=[287, 500, 31], n_valid=[1, 1, 1], t=1, mb=33, h=96, kh=8),
    "g12_prefill": dict(lengths=[250], n_valid=[27], t=32, mb=33, h=96, kh=8),
    "g48_mqa_decode_b8": dict(lengths=[287, 300, 5, 0, 511, 128, 33, 270],
                              n_valid=[1, 1, 1, 0, 1, 1, 1, 1], t=1, mb=33, h=48, kh=1),
    "g48_mqa_prefill": dict(lengths=[250, 0], n_valid=[27, 32], t=32, mb=33, h=48, kh=1,
                            poison_new=True),
}
# the prefill pieces of a 287-token prompt as the streaming engine sends
# them: t 32, the table narrowed to pow2_at_least(need) blocks of 16
_K3_CASES.update({f"prompt_piece_{p0}": dict(lengths=[p0], n_valid=[min(32, 287 - p0)],
                                             t=32, mb=w)
                  for p0, w in ((0, 2), (32, 4), (64, 8), (128, 16), (256, 32))})


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", sorted(_K3_CASES))
def test_k3_matches_plain(dev, case, dtype):
    """K3 vs its plain version: outputs of the valid queries within the
    stated tolerance (fp32: summation order; bf16: a flipped bf16
    rounding), pools bit-equal outside block 0, one launch counted."""
    args = _k3_case(dev, dtype, **_K3_CASES[case])
    if case == "cow":
        args[3][5], args[4][5] = args[3][2], args[4][2]
    ref_args = list(args)
    ref_args[3], ref_args[4] = args[3].clone(), args[4].clone()
    before = (paged_attend.LAUNCHES, paged_attend.COMBINE_LAUNCHES)
    got = paged_attend.paged_attend_fused(*args)
    want = paged_attend.paged_attend_fused_ref(*ref_args)
    torch.cuda.synchronize()
    assert (paged_attend.LAUNCHES, paged_attend.COMBINE_LAUNCHES) == (before[0] + 1,
                                                                       before[1] + 1)
    valid = torch.arange(got.shape[1], device=dev)[None] < args[7][:, None]
    tol = dict(rtol=2e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(got.float()[valid], want.float()[valid], **tol)
    assert torch.equal(args[3][1:], ref_args[3][1:])
    assert torch.equal(args[4][1:], ref_args[4][1:])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_combine_kernel_matches_combine(dev, dtype):
    """The combine kernel against `combine`: fully masked chunks are
    skipped unread (NaN acc for the kernel), a query with no visible
    position gives 0; one launch counted."""
    g = torch.Generator(device=dev).manual_seed(3)
    shape = (8, 5, 2, 24)
    acc = torch.randn(shape + (128,), generator=g, device=dev)
    m = torch.randn(shape, generator=g, device=dev) * 4
    den = torch.rand(shape, generator=g, device=dev) * 8 + 1
    m[:, 3:], den[:, 3:], acc[:, 3:] = paged_attend.NEG_INF, 0.0, 0.0
    m[1, :, 1, 7], den[1, :, 1, 7], acc[1, :, 1, 7] = paged_attend.NEG_INF, 0.0, 0.0
    want = paged_attend.combine(acc, m, den, dtype)
    acc_k = acc.clone()
    acc_k[:, 3:] = float("nan")
    before = paged_attend.COMBINE_LAUNCHES
    got = torch.empty((8, 2, 24, 128), dtype=dtype, device=dev)
    paged_attend._launch_combine(_build.load_library(), acc_k, m, den, got)
    torch.cuda.synchronize()
    assert paged_attend.COMBINE_LAUNCHES == before + 1
    tol = dict(rtol=2e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert bool((got[1, 1, 7] == 0).all())


def test_k3_refuses_what_it_does_not_take(dev):
    args = _k3_case(dev, torch.bfloat16, **_K3_CASES["decode"])
    half = [a.half() if a.is_floating_point() else a for a in args]
    with pytest.raises(TypeError, match="one dtype"):
        paged_attend.paged_attend_fused(*half)
    with pytest.raises(ValueError, match="shape"):
        paged_attend.paged_attend_fused(args[0], args[1][:, :, :4].contiguous(), *args[2:])
    with pytest.raises(ValueError, match="CUDA device"):
        paged_attend.paged_attend_fused(*args[:5], args[5].cpu(), *args[6:])
    with pytest.raises(ValueError, match="contiguous"):
        paged_attend.paged_attend_fused(args[0].transpose(2, 3).contiguous().transpose(2, 3),
                                        *args[1:])


def test_paged_query_stream_launches_k3(dev):
    """A short query_stream(paged=True, paged_kernel=True) on the SMOKE
    model: every item an error-free GenerationTicket, K3 launched once
    per layer and paged step."""
    rng = np.random.default_rng(0)
    corpus = [f"document {i}: " + " ".join(f"w{rng.integers(0, 997)}" for _ in range(12))
              for i in range(256)]
    cfg = get_config("phi4-mini-3.8b", smoke=True)
    model = build_model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    pipe = RagPipeline(corpus, RetrievalConfig(path="kernel_bitserial"), model=model,
                       embedder=HashEmbedder(dim=128), dim=128, max_prompt_len=96,
                       device=dev)
    paged_attend.LAUNCHES = 0
    reqs = [("a", corpus[3]), ("b", corpus[3]), ("a", corpus[9]), ("b", corpus[100])]
    items = list(pipe.query_stream(reqs, k=2, generate=True, max_new_tokens=4,
                                   config=EngineConfig(n_slots=2, paged=True,
                                                       paged_kernel=True)))
    assert len(items) == 4
    for it in items:
        assert isinstance(it, GenerationTicket) and it._error is None
        assert len(it.tokens) == 4
    assert paged_attend.LAUNCHES > 0 and paged_attend.LAUNCHES % cfg.n_layers == 0
    paged_attend.LAUNCHES = 0
    gen = list(pipe.generate_stream(["hello", ("b", "paged")], max_new_tokens=3,
                                    config=EngineConfig(n_slots=2, cache_len=64, paged=True,
                                                        paged_kernel=True)))
    assert sorted(len(g.tokens) for g in gen) == [3, 3]
    assert paged_attend.LAUNCHES > 0 and paged_attend.LAUNCHES % cfg.n_layers == 0


_K4_CASES = {   # rows, n, block_n, k, fill
    "monolithic": (8, 8192, 512, 3, "randn"),
    "four_macros": (32, 2048, 128, 3, "randn"),
    "flush_64_rows": (64, 4096, 256, 3, "randn"),
    "update_288_rows": (288, 4096, 256, 3, "randn"),
    "wide_k": (2, 2048, 64, 64, "randn"),
    "k_equals_block": (3, 1200, 400, 400, "randn"),
    "block_200": (3, 1000, 200, 7, "randn"),
    "block_202": (3, 606, 202, 7, "randn"),          # rows of 202: scalar loads
    "block_4096": (2, 8192, 4096, 5, "randn"),       # past the register body
    "signed_zeros": (4, 2048, 256, 40, "signed_zeros"),
    "misaligned": (8, 2048, 256, 3, "misaligned"),   # every block starts 4 bytes off
}


def _k4_scores(g, rows, n, fill, dev):
    if fill == "signed_zeros":
        return torch.where(torch.rand((rows, n), generator=g, device=dev) < 0.5, 0.0, -0.0)
    flat = torch.randn((rows * n + 1,), generator=g, device=dev)
    s = (flat[1:] if fill == "misaligned" else flat[:-1]).view(rows, n)
    s[:, 5::11] = float("-inf")
    s[0] = 0.0
    return s


@pytest.mark.parametrize("case", sorted(_K4_CASES))
def test_k4_matches_plain(dev, case):
    """Bit-equal values and block-local indices, with ties and -inf slots
    in the scores, against the plain version on the card and on the CPU;
    one launch counted."""
    rows, n, block_n, k, fill = _K4_CASES[case]
    g = torch.Generator(device=dev).manual_seed(1)
    s = _k4_scores(g, rows, n, fill, dev)
    assert (s.data_ptr() % 16 != 0) == (fill == "misaligned")
    before = topk_select.LAUNCHES
    v, i = topk_select.blockwise_topk(s, k, block_n)
    rv, ri = topk_select.blockwise_topk_ref(s, k, block_n)
    cv, ci = topk_select.blockwise_topk_ref(s.cpu(), k, block_n)
    torch.cuda.synchronize()
    assert topk_select.LAUNCHES == before + 1
    assert torch.equal(v.view(torch.int32), rv.view(torch.int32)) and torch.equal(i, ri)
    assert torch.equal(v.cpu().view(torch.int32), cv.view(torch.int32))
    assert torch.equal(i.cpu(), ci)


@pytest.mark.parametrize("rows,n,n_cores,k,fill", [
    (8, 8192, 16, 3, "randn"), (32, 2048, 16, 3, "randn"),   # the path's shapes
    (32, 4096, 16, 3, "randn"), (64, 4096, 16, 3, "randn"), (288, 4096, 16, 3, "randn"),
    (2, 2048, 16, 64, "randn"), (4, 512, 16, 40, "randn"),   # k 64; k > per
    (3, 16384, 2, 5, "randn"),                                # per 8192: streamed
    (2, 16384, 16, 500, "randn"),                             # past the fused launch
    (8, 2048, 16, 40, "signed_zeros"), (8, 2048, 16, 3, "misaligned"),
])
def test_hierarchical_select_matches_plain(dev, rows, n, n_cores, k, fill):
    """The fused local + global comparator: values and global ids
    bit-equal to its plain version on the card and on the CPU; one launch
    counted, and `core.topk.hierarchical_topk` is that one launch."""
    g = torch.Generator(device=dev).manual_seed(2)
    s = _k4_scores(g, rows, n, fill, dev)
    before = topk_select.LAUNCHES
    v, i = topk_select.hierarchical_select(s, k, n_cores)
    rv, ri = topk_select.hierarchical_select_ref(s, k, n_cores)
    cv, ci = topk_select.hierarchical_select_ref(s.cpu(), k, n_cores)
    torch.cuda.synchronize()
    assert topk_select.LAUNCHES == before + 1
    assert tuple(v.shape) == tuple(i.shape) == (rows, min(k, n)) and i.dtype == torch.int32
    assert torch.equal(v.view(torch.int32), rv.view(torch.int32)) and torch.equal(i, ri)
    assert torch.equal(v.cpu().view(torch.int32), cv.view(torch.int32))
    assert torch.equal(i.cpu(), ci)
    t = topk.hierarchical_topk(s, k, n_cores)
    assert topk_select.LAUNCHES == before + 2
    assert torch.equal(t.indices, i) and torch.equal(t.scores, v)


def test_k4_blocks_with_fewer_than_k_live_scores(dev):
    s = torch.full((4, 1024), float("-inf"), device=dev)
    s[:, 3], s[:, 700] = 1.0, 2.0
    v, i = topk_select.blockwise_topk(s, 5, 512)
    assert i[0, 0].tolist() == [3, 0, 1, 2, 4] and i[0, 1].tolist() == [188, 0, 1, 2, 3]
    assert torch.equal(i, topk_select.blockwise_topk_ref(s, 5, 512)[1])
    fv, fi = ops.local_topk_blocks(torch.zeros((2, 1024), device=dev), 4)
    assert fi.cpu().tolist() == [[0, 1, 2, 3]] * 2


@pytest.mark.parametrize("b,n,dim", [(8, 8192, 512), (3, 8229, 1024), (8, 1000, 128)])
def test_k5_matches_plain(dev, b, n, dim):
    """Bit-equal fp32 cosine scores (rtol 1e-6 is the JAX test's bound),
    a ragged n and a zero-norm query row; one launch counted."""
    g = torch.Generator(device=dev).manual_seed(2)
    q = _codes(g, (b, dim), 8, dev)
    d = _codes(g, (n, dim), 8, dev)
    q[-1] = 0
    qn, dn = int_norm(q, keepdim=True), int_norm(d)[None]
    before = score_matmul.COSINE_LAUNCHES
    got = score_matmul.score_matmul_cosine(q, d, qn, dn)
    want = score_matmul.score_matmul_cosine_ref(q, d, qn, dn)
    torch.cuda.synchronize()
    assert score_matmul.COSINE_LAUNCHES == before + 1
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
    assert torch.equal(got, want) and bool((got[-1] == 0).all())
    assert torch.equal(ops.score_matmul_cosine(q, d, dn[0]), got)


@pytest.mark.parametrize("b,n,dim", [(17, 8229, 512), (65, 300, 128), (72, 16384, 512),
                                   (3, 37, 48), (72, 37, 48), (64, 8192, 1024),
                                   (63, 1000, 3072)])
def test_k2_k5_tiling_edges(dev, b, n, dim):
    """K2 and K5 at the edges of their tiling: query tiles past 16 and past
    one 64-query pass (grid.y), n under one doc tile, a dim that is not a
    multiple of 32 (zero-filled last k-step); K2 also at dim 3072."""
    g = torch.Generator(device=dev).manual_seed(b + n + dim)
    q = _codes(g, (b, dim), 8, dev)
    d = _codes(g, (n, dim), 8, dev)
    before = (score_matmul.LAUNCHES, score_matmul.COSINE_LAUNCHES)
    got = score_matmul.score_matmul_int(q, d)
    torch.cuda.synchronize()
    assert torch.equal(got, score_matmul.score_matmul_int_ref(q, d))
    if dim <= score_matmul.COSINE_MAX_DIM:
        q[-1] = 0
        qn, dn = int_norm(q, keepdim=True), int_norm(d)[None]
        cos = score_matmul.score_matmul_cosine(q, d, qn, dn)
        torch.cuda.synchronize()
        assert torch.equal(cos, score_matmul.score_matmul_cosine_ref(q, d, qn, dn))
        assert bool((cos[-1] == 0).all())
    assert score_matmul.LAUNCHES == before[0] + 1
    assert score_matmul.COSINE_LAUNCHES == before[1] + (dim <= score_matmul.COSINE_MAX_DIM)


def test_k2_k5_all_most_negative_codes(dev):
    """All -128 codes, the largest |ip|: K2 at dim 3072 gives 3072 * 128^2
    everywhere, K5 at dim 1024 gives 2^24 / (4096 * 4096) = 1 exactly."""
    q = torch.full((72, 3072), -128, dtype=torch.int8, device=dev)
    d = torch.full((8229, 3072), -128, dtype=torch.int8, device=dev)
    got = score_matmul.score_matmul_int(q, d)
    torch.cuda.synchronize()
    assert bool((got == 3072 * 128 * 128).all())
    assert torch.equal(got, score_matmul.score_matmul_int_ref(q, d))
    q, d = q[:, :1024].contiguous(), d[:, :1024].contiguous()
    qn, dn = int_norm(q, keepdim=True), int_norm(d)[None]
    cos = score_matmul.score_matmul_cosine(q, d, qn, dn)
    torch.cuda.synchronize()
    assert bool((cos == 1.0).all())
    assert torch.equal(cos, score_matmul.score_matmul_cosine_ref(q, d, qn, dn))


def test_k2_k5_refuse_what_they_do_not_take(dev):
    """K2 past dim 3072 (the kernel's own refusal) and operands that do
    not start on 16-byte boundaries (dim % 16 and K5 past dim 1024: the
    other refusal tests)."""
    i8 = dict(dtype=torch.int8, device=dev)
    with pytest.raises(RuntimeError, match="CUDA error"):
        score_matmul.score_matmul_int(torch.zeros((2, 3088), **i8),
                                      torch.zeros((5, 3088), **i8))
    buf = torch.zeros(16 * 48 + 1, **i8)
    misaligned = buf[1:].view(16, 48)
    assert misaligned.is_contiguous() and misaligned.data_ptr() % 16
    docs = torch.zeros((5, 48), **i8)
    with pytest.raises(ValueError, match="16-byte aligned"):
        score_matmul.score_matmul_int(misaligned[:2], docs)
    with pytest.raises(ValueError, match="16-byte aligned"):
        score_matmul.score_matmul_int(docs[:2], misaligned)
    with pytest.raises(ValueError, match="16-byte aligned"):
        score_matmul.score_matmul_cosine(misaligned[:2], docs, torch.ones((2, 1), device=dev),
                                         torch.ones((1, 5), device=dev))


def test_k4_k5_refuse_what_they_do_not_take(dev):
    with pytest.raises(TypeError):
        topk_select.blockwise_topk(torch.zeros((2, 512), dtype=torch.float16, device=dev), 3)
    with pytest.raises(ValueError, match="CUDA device"):
        score_matmul.score_matmul_cosine(
            torch.zeros((2, 32), dtype=torch.int8, device=dev),
            torch.zeros((4, 32), dtype=torch.int8, device=dev),
            torch.ones((2, 1)), torch.ones((1, 4), device=dev))
    with pytest.raises(TypeError):
        score_matmul.score_matmul_cosine(
            torch.zeros((2, 32), device=dev), torch.zeros((4, 32), device=dev),
            torch.ones((2, 1), device=dev), torch.ones((1, 4), device=dev))
    with pytest.raises(ValueError, match="dim <= 1024"):
        ops.score_matmul_cosine(torch.zeros((2, 1040), dtype=torch.int8, device=dev),
                                torch.zeros((4, 1040), dtype=torch.int8, device=dev),
                                torch.ones(4, device=dev))
    # shard_map without a process group: every macro scored here (the
    # one-device fallback), no refusal; the mesh runs are below
    emb = np.random.default_rng(0).normal(size=(64, 32)).astype(np.float32)
    idx = ShardedDircIndex.build(emb, RetrievalConfig(), parallelism="shard_map", device=dev)
    assert idx.mesh is None and idx._macro_block() is None


@pytest.mark.parametrize("path", ["int_exact", "kernel_bitserial", "kernel_mxu"])
def test_sharded_search_on_the_card_equals_the_cpu(dev, path):
    """A 4-macro index (capacity 256, 16 cores of 16) searched on the card
    equals the same index searched on the CPU, K4 launched once per
    search; add / delete stay in step."""
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(1024, 128)).astype(np.float32)
    cfg = RetrievalConfig(path=path)
    on_card = ShardedDircIndex.build(emb, cfg, n_shards=4, device=dev)
    on_cpu = ShardedDircIndex.build(emb, cfg, n_shards=4, device="cpu")
    before = topk_select.LAUNCHES
    a, b = on_card.search(emb[:8], 5), on_cpu.search(emb[:8], 5)
    assert topk_select.LAUNCHES == before + 1
    assert torch.equal(a.indices.cpu(), b.indices) and torch.equal(a.scores.cpu(), b.scores)
    assert a.indices[:, 0].tolist() == list(range(8))
    new = rng.normal(size=(6, 128)).astype(np.float32)
    assert on_card.add_docs(new).tolist() == on_cpu.add_docs(new).tolist()
    assert on_card.delete_docs([0, 1025]) == on_cpu.delete_docs([0, 1025]) == 2
    a, b = on_card.search(new, 5), on_cpu.search(new, 5)
    assert torch.equal(a.indices.cpu(), b.indices) and torch.equal(a.scores.cpu(), b.scores)


# ------------------------------------------------- generation serving on the card
def _smoke_fp32(dev):
    cfg = dataclasses.replace(get_config("phi4-mini-3.8b", smoke=True),
                              compute_dtype="float32")
    return build_model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))


def _gen_prompts(vocab, n=6, seed=0):
    """(prompt, prefix_len): two 20-token headers, each shared by several
    prompts, then a 6-token query."""
    rng = np.random.default_rng(seed)
    hdr = [rng.integers(0, vocab, size=20) for _ in range(2)]
    return [(np.concatenate([hdr[i % 2], rng.integers(0, vocab, size=6)]), 20)
            for i in range(n)]


_GEN_CFG = EngineConfig(n_slots=2, cache_len=64, paged=True, paged_kernel=True,
                        block_size=8, prefill_chunk=8, prefix_sharing=True)


def test_host_tier_round_trip_on_card(dev):
    """A prefix parked in the host tier and swapped back into fresh blocks
    holds the same KV bits as before it left the card."""
    from repro_torch.serving import ContinuousBatchingEngine

    model = _smoke_fp32(dev)
    (pa, la), (pb, lb) = _gen_prompts(model.cfg.vocab_size)[:2]
    eng = ContinuousBatchingEngine(
        model, _GEN_CFG.replace(n_slots=1, n_blocks=16, retain_blocks=3, host_blocks=8),
        device=dev)
    first = eng.submit(pa, max_new_tokens=3, prefix_len=la).result().tolist()
    key = eng.compute_prefix_key(pa, la)[0]
    blocks = list(eng._pcm._prefix_index[key].blocks)
    before = (eng._pools.k_pool[:, blocks].clone(), eng._pools.v_pool[:, blocks].clone())
    eng.submit(pb, max_new_tokens=3, prefix_len=lb).result()
    assert eng._pcm.host_keys() == [key]
    again = eng.submit(pa, max_new_tokens=3, prefix_len=la).result().tolist()
    after = list(eng._pcm._prefix_index[key].blocks)
    assert eng.stats()["pool"]["n_host_hits"] == 1
    assert torch.equal(eng._pools.k_pool[:, after], before[0])
    assert torch.equal(eng._pools.v_pool[:, after], before[1])
    assert again == first
    assert eng.clear_prefix_cache() >= 1
    pool = eng.stats()["pool"]
    assert pool["free_blocks"] == pool["n_usable_blocks"] and not eng._host_kv


@pytest.mark.parametrize("retain", [0, 8])
def test_preempt_resume_tokens_with_k3(dev, retain):
    """Preempted mid-decode and resumed (re-attach with retention, a full
    re-prefill without), a request gives the uninterrupted run's tokens;
    K3 launched once per layer and paged step."""
    from repro_torch.serving import ContinuousBatchingEngine

    model = _smoke_fp32(dev)
    p, pl = _gen_prompts(model.cfg.vocab_size)[0]
    cfg = _GEN_CFG.replace(retain_blocks=retain)
    want = ContinuousBatchingEngine(model, cfg, device=dev).submit(
        p, max_new_tokens=10, prefix_len=pl).result().tolist()
    eng = ContinuousBatchingEngine(model, cfg, device=dev)
    paged_attend.LAUNCHES = 0
    t = eng.submit(p, max_new_tokens=10, prefix_len=pl)
    while len(t.tokens) < 4:
        eng.step()
    assert eng.preempt() and t.slot is None
    eng.run_until_drained()
    st = eng.stats()
    assert t.result().tolist() == want
    assert st["n_preemptions"] == st["n_resumes"] == 1
    if retain:
        assert st["pool"]["n_device_hits"] == 1
    steps = st["n_decode_steps"] + st["n_prefill_chunks"]
    assert paged_attend.LAUNCHES == model.cfg.n_layers * steps


def test_routed_fleet_on_card_equals_cpu(dev):
    """The same 2-replica routed run (affinity, retention) on the card and
    on the CPU, with the same weights: the same placements and tokens."""
    from repro_torch.serving import EngineRouter

    card = _smoke_fp32(dev)
    host = build_model(card.cfg, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    reqs = _gen_prompts(card.cfg.vocab_size)
    runs = []
    for model, device in ((card, dev), (host, "cpu")):
        r = EngineRouter(model, _GEN_CFG.replace(retain_blocks=8), n_replicas=2,
                         device=device)
        ts = [r.submit(p, max_new_tokens=5, prefix_len=pl) for p, pl in reqs]
        r.run_until_drained()
        st = r.stats()
        runs.append(([t.result().tolist() for t in ts], [t.replica for t in ts],
                     st["n_affinity_hits"], st["fleet"]["n_prefix_hits"]))
        r.close()
    assert runs[0] == runs[1]
    assert runs[0][2] >= 1 and sorted(set(runs[0][1])) == [0, 1]


def test_launch_counts_exact_across_threads(dev):
    """Eight threads launch the fused top-k 50 times each with a tiny
    interpreter switch interval: the count is exact (a bare `+= 1` on the
    module global could lose updates)."""
    import sys
    import threading

    from repro_torch.kernels import counters

    s = torch.randn((4, 2048), device=dev)
    topk_select.hierarchical_select(s, 3, 16)   # build / load first
    counters.reset()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [topk_select.hierarchical_select(s, 3, 16)
                                                    for _ in range(50)])
                   for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert counters.read()["topk_select"] == 400


@pytest.mark.parametrize("arch,dtype", [("phi3.5-moe-42b-a6.6b", torch.float32),
                                        ("arctic-480b", torch.float32),
                                        ("phi3.5-moe-42b-a6.6b", torch.bfloat16)])
def test_apply_moe_on_card_equals_cpu(dev, arch, dtype):
    """`apply_moe` on the card against the CPU on the same weights and
    inputs, at the decode-step (8 rows) and prefill-piece (32 rows) call
    sizes with their capacity drops: the same tokens kept, outputs within
    1e-5 at fp32, 2e-2 at bf16 (two bf16 ulps)."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), compute_dtype=str(dtype)[6:],
                              param_dtype=str(dtype)[6:], n_layers=1)
    card = build_model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(1))
    p_card = card.blocks[0].moe
    host = build_model(cfg, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    p_host = host.blocks[0].moe
    g = torch.Generator().manual_seed(2)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    for shape in ((8, 1), (1, 32)):
        x = torch.randn(shape + (cfg.d_model,), generator=g).to(dtype)
        y_h, aux_h = moe_mod.apply_moe(cfg, p_host, x)
        y_c, aux_c = moe_mod.apply_moe(cfg, p_card, x.to(dev))
        assert y_c.device.type == "cuda" and y_c.dtype == dtype
        torch.testing.assert_close(y_c.cpu().float(), y_h.float(), **tol)
        assert float(aux_c.dropped_fraction) == float(aux_h.dropped_fraction)


def _card_and_host(arch, dev):
    """`arch`'s smoke model in fp32 on the card and a copy on the CPU."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), compute_dtype="float32")
    card = build_model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(3))
    host = build_model(cfg, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    return cfg, card, host


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b", "whisper-small"])
def test_ssm_hybrid_audio_on_card_equal_cpu(dev, arch):
    """The chunked SSD forward (the encoder-decoder's teacher-forced one)
    and 6 streamed decode steps on the card against the CPU, fp32 with
    TF32 off (PyTorch's default), within 1e-4."""
    cfg, card, host = _card_and_host(arch, dev)
    g = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), generator=g)
    extra = []
    if cfg.encoder is not None:
        extra = [torch.randn((2, cfg.encoder.n_frames, cfg.encoder.d_model), generator=g)]
    want = host.forward(toks, *extra)
    got = card.forward(toks.to(dev), *[e.to(dev) for e in extra])
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    ch, cc = host.init_caches(2, 8, 0), card.init_caches(2, 8, 0)
    for t in range(6):
        lh, ch = host.decode_step(ch, toks[:, t:t + 1])
        lc, cc = card.decode_step(cc, toks[:, t:t + 1].to(dev))
        torch.testing.assert_close(lc.cpu(), lh, rtol=1e-4, atol=1e-4)


def test_slot_resident_engine_on_card_equals_cpu(dev):
    """mamba2's slot-resident paged engine (chunked admission into a b-1
    cache, full-width decode) on the card gives the CPU engine's greedy
    tokens at fp32, and `GenerationEngine`'s."""
    from repro_torch.serving import ContinuousBatchingEngine, GenerationEngine

    cfg, card, host = _card_and_host("mamba2-2.7b", dev)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (9, 14, 5, 11)]
    ecfg = EngineConfig(n_slots=2, cache_len=32, paged=True, prefill_chunk=4)
    out = []
    for model, device in ((card, dev), (host, "cpu")):
        eng = ContinuousBatchingEngine(model, ecfg, device=device)
        ts = [eng.submit(p, max_new_tokens=5) for p in prompts]
        eng.run_until_drained()
        assert "pool" not in eng.stats()
        out.append([t.result().tolist() for t in ts])
    assert out[0] == out[1]
    gen = GenerationEngine(card, device=dev)
    assert out[0] == [gen.generate([p], 5)[0].tolist() for p in prompts]


# ------------------------------------------------------------------ training
def test_head_loss_identity_full_vocab_on_card(dev):
    """The fused head loss equals cross_entropy_loss over the explicit
    logits at phi4-mini's full 200064 vocab (padded 200192), loss and the
    gradients of the hidden states and the tied head: fp32 tightly, bf16
    within 2e-2 of each result's largest magnitude."""
    from repro_torch.models import layers

    base = get_config("phi4-mini-3.8b")
    g = torch.Generator(device=dev).manual_seed(0)
    emb = torch.randn((base.padded_vocab_size, base.d_model), generator=g, device=dev) * 0.02
    h0 = torch.randn((2, 48, base.d_model), generator=g, device=dev)
    lab = torch.randint(0, base.vocab_size, (2, 48), generator=g, device=dev)
    lab[0, :5] = -1
    for dtype, tol in (("float32", 1e-5), ("bfloat16", 2e-2)):
        cfg = dataclasses.replace(base, compute_dtype=dtype)

        def run(fused):
            e, h = emb.clone().requires_grad_(True), h0.clone().requires_grad_(True)
            loss = (layers.lm_head_loss(cfg, e, h, lab) if fused else
                    layers.cross_entropy_loss(layers.logits_from_hidden(cfg, e, h), lab))
            return [loss.detach(), *torch.autograd.grad(loss, [h, e])]
        for a, b in zip(run(True), run(False)):
            err = float((a.float() - b.float()).abs().max() / b.float().abs().max())
            assert err <= tol, (dtype, err)


def _preempt(train_mod, monkeypatch, at):
    batch_at = train_mod.DataPipeline.batch_at

    def preempting(self, step):
        if step == at:
            raise KeyboardInterrupt
        return batch_at(self, step)
    monkeypatch.setattr(train_mod.DataPipeline, "batch_at", preempting)
    return batch_at


def test_deterministic_resume_on_card(dev, tmp_path, monkeypatch):
    """Under deterministic algorithms a run preempted at step 8 and resumed
    from its step-6 checkpoint repeats the straight run's losses bit for
    bit on the card."""
    from repro_torch.launch import train as train_mod

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    kw = dict(smoke=True, steps=12, batch=4, seq=32, lr=5e-3, log_every=1000, device=dev)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        full = train_mod.train("mamba2-2.7b", **kw)
        batch_at = _preempt(train_mod, monkeypatch, 8)
        with pytest.raises(KeyboardInterrupt):
            train_mod.train("mamba2-2.7b", ckpt_dir=str(tmp_path), ckpt_every=3, **kw)
        monkeypatch.setattr(train_mod.DataPipeline, "batch_at", batch_at)
        resumed = train_mod.train("mamba2-2.7b", ckpt_dir=str(tmp_path), ckpt_every=100, **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    assert resumed["losses"] == full["losses"][6:]
    assert resumed["model"].embed.device.type == "cuda"


def test_bf16_checkpoint_round_trip_on_card(dev, tmp_path):
    """bf16 leaves on the card (NaN payloads and -0.0 included) save and
    restore bit for bit, onto the card and onto the CPU."""
    from repro_torch.checkpointing import CheckpointManager

    bits = torch.tensor([0x0000, -0x8000, 0x3F80, 0x7FC1, -0x0080, 0x0001, 0x7F7F],
                        dtype=torch.int16)
    x = torch.cat([bits, torch.randint(-2**15, 2**15 - 1, (1000,), dtype=torch.int16)])
    tree = {"w": x.view(torch.bfloat16).to(dev), "f": torch.randn(5, device=dev)}
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, tree)
    tree["w"].zero_()            # the async save snapshot is taken before this
    mgr.wait()
    _, on_card = mgr.restore(tree)
    _, on_cpu = mgr.restore(tree, device="cpu")
    assert on_card["w"].device.type == "cuda" and on_cpu["w"].device.type == "cpu"
    assert torch.equal(on_card["w"].view(torch.int16).cpu(), x)
    assert torch.equal(on_cpu["w"].view(torch.int16), x)
    assert torch.equal(on_card["f"].cpu(), on_cpu["f"])


def test_mesh_searcher_and_shard_map_index_on_card(dev, tmp_path):
    """A one-rank NCCL group: the flat-index searcher over the macro mesh
    (K2 + K4, two all-gathers) against the flat top-k by the plain
    versions on the CPU, bit for bit, cosine and MIPS; and the 4-macro
    index with `parallelism="shard_map"` against `vmap` on the all-gather
    route (int_exact) and the kernel route (kernel_bitserial)."""
    from repro_torch.core import quantization
    from repro_torch.core.sharded_index import make_distributed_searcher, shard_index_arrays
    from repro_torch.launch import mesh as mesh_mod

    rng = np.random.default_rng(0)
    emb = rng.normal(size=(2048, 128)).astype(np.float32)
    with mesh_mod.distributed(0, 1, store_path=str(tmp_path / "store"), device=dev):
        mesh = mesh_mod.make_macro_mesh(device=dev)
        docs = quantization.quantize(torch.as_tensor(emb, device=dev), bits=8, per_row=True)
        codes, norms = docs.values, quantization.doc_int_norms(docs)
        q = quantization.quantize_query(torch.as_tensor(emb[:8] + 0.05, device=dev)).values
        d_sh, n_sh = shard_index_arrays(mesh, codes, norms)
        for metric in ("cosine", "mips"):
            before = (score_matmul.LAUNCHES, topk_select.LAUNCHES)
            got = make_distributed_searcher(mesh, 8, metric=metric)(q, d_sh, n_sh)
            torch.cuda.synchronize()
            assert (score_matmul.LAUNCHES - before[0], topk_select.LAUNCHES - before[1]) == (1, 2)
            ip = score_matmul.score_matmul_int_ref(q.cpu(), codes.cpu()).float()
            if metric == "cosine":
                qn = torch.sqrt(torch.sum(q.cpu().float() ** 2, dim=-1, keepdim=True))
                ip = ip / torch.clamp_min(qn * norms.cpu()[None, :], 1e-12)
            want = topk.local_topk(ip, 8)
            assert torch.equal(got.indices.cpu(), want.indices)
            assert torch.equal(got.scores.cpu(), want.scores)
        for path in ("int_exact", "kernel_bitserial"):
            cfg = RetrievalConfig(bits=8, metric="cosine", path=path)
            vm = ShardedDircIndex.build(emb, cfg, n_shards=4, device=dev)
            sm = ShardedDircIndex.build(emb, cfg, n_shards=4, parallelism="shard_map",
                                        device=dev)
            assert sm.mesh is not None
            assert (sm._macro_block() is None) == (path == "kernel_bitserial")
            a, b = vm.search(emb[:16], 5), sm.search(emb[:16], 5)
            assert torch.equal(a.indices, b.indices) and torch.equal(a.scores, b.scores)


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "phi3.5-moe-42b-a6.6b", "mamba2-2.7b"])
def test_inference_steps_on_card_equal_cpu(dev, tmp_path, arch):
    """The production serve and prefill steps (`launch.steps.build_cell`)
    at world size 1, smoke size, fp32: a one-rank NCCL group on the card
    against a one-rank gloo group on the CPU, the same weights, caches and
    batches. Tokens equal, caches within 1e-5."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.steps import build_cell, cache_leaves

    cfg = dataclasses.replace(get_config(arch, smoke=True), compute_dtype="float32")
    state = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0)).state_dict()
    decode, prefill = ShapeConfig("decode_32k", 32, 4, "decode"), \
        ShapeConfig("prefill_32k", 32, 2, "prefill")
    g = torch.Generator().manual_seed(1)
    token = torch.randint(0, cfg.vocab_size, (4, 1), generator=g)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=g)

    def run(device, store):
        with mesh_mod.distributed(0, 1, store_path=str(store), device=device):
            mesh = mesh_mod.make_local_mesh(1, device=device)
            serve = build_cell(cfg, mesh, decode, device=device)
            serve.load_state_dict(state)
            caches = serve.new_caches(20)
            fill = torch.Generator().manual_seed(2)
            with torch.inference_mode():
                for t in cache_leaves(caches).values():
                    if t.is_floating_point():
                        t.copy_(torch.randn(t.shape, generator=fill))
            tok, caches = serve.fn(caches, {"token": token.to(device)})
            pre = build_cell(cfg, mesh, prefill, device=device)
            pre.load_state_dict(state)
            ptok = pre.fn({"tokens": tokens.to(device)})
            return (tok.cpu(), {p: t.cpu() for p, t in cache_leaves(caches).items()},
                    ptok.cpu())

    cpu, card = run("cpu", tmp_path / "a"), run(dev, tmp_path / "b")
    assert torch.equal(cpu[0], card[0]) and torch.equal(cpu[2], card[2])
    for p, want in cpu[1].items():
        torch.testing.assert_close(card[1][p], want, atol=1e-5, rtol=1e-5)
