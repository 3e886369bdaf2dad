"""Port vs JAX: paged attention (`models.attention.paged_attend`) and K3's
plain version (`kernels.paged_attend.paged_attend_fused_ref`), case for
case as tests/test_paged_attend_kernel.py holds the Pallas kernel.

The oracle is the JAX gather path (`paged_attend(paged_kernel=False)`):
the Pallas kernel itself cannot serve, it raises on this JAX version.
Outputs agree within the JAX test's `TOL` (fp32; 3e-2 for bf16). Pools
are compared outside block 0 (NULL_BLOCK is scratch with unspecified
content): K3's plain version fed the JAX path's own post-RoPE q/k/v
writes the JAX pools bit for bit, and the port's gather and fused paths
write bit-identical pools; the port's full path differs from JAX's only
in its own fp32 projection of x (allclose), and not at all in bf16."""
import pytest

torch = pytest.importorskip("torch")

import functools  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_parity import converted_models, to_numpy, to_torch  # noqa: E402

from repro.configs.base import ModelConfig as JaxModelConfig  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import rope as jrope  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JaxEngine  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.kernels import paged_attend as K3  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import rope as trope  # noqa: E402
from repro_torch.serving import ContinuousBatchingEngine, EngineConfig  # noqa: E402
from repro_torch.serving.paged_cache import blocks_for, pow2_at_least  # noqa: E402

TOL = dict(rtol=2e-5, atol=1e-5)


def _cfgs(**kw):
    base = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
                n_kv_heads=2, d_ff=64, vocab_size=128, head_dim=8, attn_chunk=16,
                compute_dtype="float32")
    base.update(kw)
    return JaxModelConfig(**base), ModelConfig(**base)


def _params(jcfg, seed):
    jp = JA.init_attention(jcfg, jax.random.key(seed))
    tp = SimpleNamespace(**{k: to_torch(np.asarray(v)) for k, v in jp.items()})
    return jp, tp


def _bf16_np(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _mk_case(rng, jcfg, b, t, bs, mb, lengths, n_valid, tables=None,
             null_garbage=False, bf16=False):
    """Numpy inputs (the JAX test's layout): row r owns blocks 1 + r*mb ..
    unless an explicit `tables` layout is given."""
    kh, hd = jcfg.n_kv_heads, jcfg.resolved_head_dim
    n_blocks = b * mb + 2
    kp = rng.normal(size=(n_blocks, bs, kh, hd)).astype(np.float32)
    vp = rng.normal(size=(n_blocks, bs, kh, hd)).astype(np.float32)
    if null_garbage:   # NULL_BLOCK content must never leak into outputs
        kp[0] = 1e6
        vp[0] = -1e6
    if tables is None:
        tables = np.zeros((b, mb), np.int32)
        for r in range(b):
            need = -(-int(lengths[r] + t) // bs)
            for i in range(min(need, mb)):
                tables[r, i] = 1 + r * mb + i
    if bf16:
        kp, vp = _bf16_np(kp), _bf16_np(vp)
    x = rng.normal(size=(b, t, jcfg.d_model)).astype(np.float32)
    return dict(kp=kp, vp=vp, tables=np.asarray(tables, np.int32),
                lengths=np.asarray(lengths, np.int32),
                n_valid=np.asarray(n_valid, np.int32), x=x)


def _pool_t(a):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16)
    return to_torch(a)


@functools.partial(jax.jit, static_argnums=0)
def _jax_gather_jit(jcfg, jp, x, kp, vp, tables, lengths, n_valid):
    cache = JA.PagedKVCache(k_pool=kp, v_pool=vp, block_table=tables, length=lengths)
    t = x.shape[1]
    pos = lengths[:, None] + jnp.arange(t)[None, :]
    angles = jrope.rope_angles(pos, jcfg.resolved_head_dim, jcfg.rope_theta)
    y, k, v = JA.paged_attend(jcfg, jp, x, cache, angles, n_valid, paged_kernel=False)
    h, kh, hd = jcfg.n_heads, jcfg.n_kv_heads, jcfg.resolved_head_dim
    q, kn, vn = JA._project_qkv(jcfg, jp, x, h, kh, hd)
    return (y, k, v), (jrope.apply_rotary(q, angles), jrope.apply_rotary(kn, angles), vn)


def _jax_gather(jcfg, jp, c):
    """The JAX gather path's (y, k_pool, v_pool) in fp32, and the post-RoPE
    (q, k_new, v_new) it computed, as port tensors."""
    (y, k, v), qkv = _jax_gather_jit(
        jcfg, jp, *(jnp.asarray(c[n]) for n in ("x", "kp", "vp", "tables",
                                                 "lengths", "n_valid")))
    return (np.asarray(y, np.float32), np.asarray(k, np.float32),
            np.asarray(v, np.float32)), tuple(_pool_t(np.asarray(a)) for a in qkv)


def _port(tcfg, tp, c, paged_kernel):
    cache = TA.PagedKVCache(k_pool=_pool_t(c["kp"]), v_pool=_pool_t(c["vp"]),
                            block_table=to_torch(c["tables"]),
                            length=to_torch(c["lengths"]))
    t = c["x"].shape[1]
    pos = cache.length.long()[:, None] + torch.arange(t)[None, :]
    angles = trope.rope_angles(pos, tcfg.resolved_head_dim, tcfg.rope_theta)
    y, k, v = TA.paged_attend(tcfg, tp, to_torch(c["x"]), cache, angles,
                              to_torch(c["n_valid"]), paged_kernel=paged_kernel)
    return (to_numpy(y.float()), to_numpy(k.float()), to_numpy(v.float()))


def _k3_on_jax_inputs(tp, c, qkv, chunk_blocks=None):
    """K3's plain version on the JAX path's own post-RoPE q/k/v: its pool
    writes are then the JAX gather path's bit for bit."""
    q, kn, vn = qkv
    kp, vp = _pool_t(c["kp"]), _pool_t(c["vp"])
    out = K3.paged_attend_fused(q, kn, vn, kp, vp, to_torch(c["tables"]),
                                to_torch(c["lengths"]), to_torch(c["n_valid"]),
                                chunk_blocks=chunk_blocks)
    b, t = q.shape[:2]
    y = out.reshape(b, t, -1).to(tp.wo.dtype) @ tp.wo
    return to_numpy(y.float()), to_numpy(kp.float()), to_numpy(vp.float())


def _assert_parity(want, got, nv, pools_exact=True, **tol):
    tol = tol or TOL
    rows = np.asarray(nv) > 0
    np.testing.assert_allclose(got[0][rows], want[0][rows], **tol)
    for g, w in zip(got[1:], want[1:]):
        if pools_exact:
            np.testing.assert_array_equal(g[1:], w[1:])
        else:   # written cells hold each package's own projection of x
            np.testing.assert_allclose(g[1:], w[1:], **tol)


def _check_all(jcfg, tcfg, jp, tp, c, **tol):
    """JAX gather vs the port's gather path, its fused path (K3's plain
    version) and K3 on the JAX inputs. The port's two paths write
    bit-identical pools; K3 on the JAX inputs writes the JAX pools."""
    want, qkv = _jax_gather(jcfg, jp, c)
    outs = {pk: _port(tcfg, tp, c, pk) for pk in (False, True)}
    exact = jcfg.compute_dtype == "bfloat16"   # bf16 projections round alike
    for got in outs.values():
        _assert_parity(want, got, c["n_valid"], pools_exact=exact, **tol)
    for a, b in zip(outs[False][1:], outs[True][1:]):
        np.testing.assert_array_equal(a[1:], b[1:])
    _assert_parity(want, _k3_on_jax_inputs(tp, c, qkv), c["n_valid"], **tol)
    return want, outs


@pytest.fixture(scope="module")
def mini():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, 0)
    return jcfg, tcfg, jp, tp


# ------------------------------------------------------------- core parity
@pytest.mark.parametrize("chunk_blocks", [None, 1, 2])
def test_parity_decode_t1(rng, mini, chunk_blocks):
    jcfg, tcfg, jp, tp = mini
    c = _mk_case(rng, jcfg, b=4, t=1, bs=4, mb=6, lengths=[5, 8, 0, 23],
                 n_valid=[1, 1, 0, 1])
    want, qkv = _jax_gather(jcfg, jp, c)
    _assert_parity(want, _port(tcfg, tp, c, False), c["n_valid"], pools_exact=False)
    _assert_parity(want, _k3_on_jax_inputs(tp, c, qkv, chunk_blocks), c["n_valid"])


@pytest.mark.parametrize("t,lengths,n_valid", [
    (8, [2, 0], [8, 5]),          # chunked prefill, mixed fill
    (8, [0, 0], [8, 8]),          # first chunk from empty
    (5, [9, 3], [5, 2]),          # odd t, partial validity
])
def test_parity_chunked_prefill(rng, mini, t, lengths, n_valid):
    jcfg, tcfg, jp, tp = mini
    c = _mk_case(rng, jcfg, b=2, t=t, bs=4, mb=8, lengths=lengths, n_valid=n_valid)
    _check_all(jcfg, tcfg, jp, tp, c)


@pytest.mark.parametrize("p0", [0, 8, 16, 24, 32])
def test_parity_prompt_pieces_on_narrowed_tables(rng, mini, p0):
    """Each prefill piece of a 37-token prompt (t 8, blocks of 4) as the
    engine sends it: the table narrowed to pow2_at_least(need) blocks
    (2, 4, 8, 8, 16), one chunk for the JAX path and the port's paths,
    chunks of 4 blocks for K3 on the JAX inputs (1 to 4 of them)."""
    jcfg, tcfg, jp, tp = mini
    n = min(8, 37 - p0)
    w = pow2_at_least(blocks_for(p0 + n, 4))
    c = _mk_case(rng, jcfg, b=1, t=8, bs=4, mb=w, lengths=[p0], n_valid=[n])
    want, _ = _check_all(jcfg, tcfg, jp, tp, c)
    _, qkv = _jax_gather(jcfg, jp, c)
    _assert_parity(want, _k3_on_jax_inputs(tp, c, qkv, chunk_blocks=4), c["n_valid"])


def test_parity_bf16_pools(rng):
    jcfg, tcfg = _cfgs(compute_dtype="bfloat16")
    jp, tp = _params(jcfg, 1)
    c = _mk_case(rng, jcfg, b=2, t=1, bs=4, mb=4, lengths=[5, 9], n_valid=[1, 1],
                 bf16=True)
    _check_all(jcfg, tcfg, jp, tp, c, rtol=3e-2, atol=3e-2)


# --------------------------------------- block-boundary edge-case suite
def test_edge_length_exactly_at_block_boundary(rng, mini):
    jcfg, tcfg, jp, tp = mini
    c = _mk_case(rng, jcfg, b=3, t=1, bs=4, mb=6, lengths=[4, 8, 12],
                 n_valid=[1, 1, 1])
    _check_all(jcfg, tcfg, jp, tp, c)


def test_edge_prefill_fills_block_exactly(rng, mini):
    jcfg, tcfg, jp, tp = mini
    c = _mk_case(rng, jcfg, b=2, t=6, bs=4, mb=6, lengths=[2, 6], n_valid=[6, 6])
    _check_all(jcfg, tcfg, jp, tp, c)


def test_edge_inactive_lanes(rng, mini):
    jcfg, tcfg, jp, tp = mini
    tables = np.zeros((4, 5), np.int32)
    tables[0, :3] = [1, 2, 3]
    tables[2, :2] = [4, 5]
    c = _mk_case(rng, jcfg, b=4, t=1, bs=4, mb=5, lengths=[9, 0, 4, 0],
                 n_valid=[1, 0, 1, 0], tables=tables)
    _check_all(jcfg, tcfg, jp, tp, c)


def test_edge_prefill_crosses_cow_shared_partial_block(rng, mini):
    """Rows share full block 1; row 0 continues in its CoW copy (5) of the
    shared partial block 2, then its own block 6; the still-shared blocks
    come through bit-identical on every path."""
    jcfg, tcfg, jp, tp = mini
    bs, mb = 4, 6
    tables = np.zeros((2, mb), np.int32)
    tables[0, :3] = [1, 5, 6]
    tables[1, :3] = [1, 2, 7]
    c = _mk_case(rng, jcfg, b=2, t=4, bs=bs, mb=mb, lengths=[bs + 2, 2 * bs],
                 n_valid=[4, 1], tables=tables)
    c["kp"][5], c["vp"][5] = c["kp"][2], c["vp"][2]
    shared_k = c["kp"][[1, 2]].copy()
    want, outs = _check_all(jcfg, tcfg, jp, tp, c)
    for _, kp, _vp in (want, *outs.values()):
        np.testing.assert_array_equal(kp[[1, 2]], shared_k)


def test_edge_null_tail_garbage_masked(rng, mini):
    jcfg, tcfg, jp, tp = mini
    c = _mk_case(rng, jcfg, b=2, t=1, bs=4, mb=12, lengths=[5, 2], n_valid=[1, 1],
                 null_garbage=True)
    _, outs = _check_all(jcfg, tcfg, jp, tp, c)
    for y, _, _ in outs.values():
        assert np.all(np.abs(y) < 1e4)


def test_fused_plain_writes_nothing_for_invalid_lanes(rng, mini):
    """K3 skips the scatter for invalid lanes (the gather path sends them
    to NULL_BLOCK): with n_valid all 0 the plain version leaves every
    pool block, block 0 included, untouched."""
    jcfg, tcfg, jp, tp = mini
    c = _mk_case(rng, jcfg, b=2, t=3, bs=4, mb=4, lengths=[0, 5], n_valid=[0, 0])
    _, k, v = _port(tcfg, tp, c, True)
    np.testing.assert_array_equal(k, c["kp"])
    np.testing.assert_array_equal(v, c["vp"])


def test_wrapper_refuses_what_it_does_not_take(mini):
    q = torch.zeros((1, 1, 4, 8))
    kv = torch.zeros((1, 1, 2, 8))
    pool = torch.zeros((3, 4, 2, 8))
    tbl, ln = torch.zeros((1, 2), dtype=torch.int32), torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(TypeError, match="one dtype"):
        K3.paged_attend_fused(q, kv, kv, pool.double(), pool.double(), tbl, ln, ln)
    with pytest.raises(ValueError, match="shape"):
        K3.paged_attend_fused(q, kv[:, :, :1], kv, pool, pool, tbl, ln, ln)
    with pytest.raises(TypeError, match="integer"):
        K3.paged_attend_fused(q, kv, kv, pool, pool, tbl.float(), ln, ln)


def _partials(seed, b=2, nc=4, t=3, h=4, hd=8):
    rng = np.random.default_rng(seed)
    acc = torch.from_numpy(rng.normal(size=(b, nc, t, h, hd)).astype(np.float32))
    m = torch.from_numpy(rng.normal(size=(b, nc, t, h)).astype(np.float32))
    den = torch.from_numpy(rng.uniform(0.5, 4.0, size=(b, nc, t, h)).astype(np.float32))
    return acc, m, den


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_combine_ignores_fully_masked_chunks(dtype):
    """A fully masked chunk (m = NEG_INF, den = 0) adds nothing, whatever
    its acc holds: the combine of all chunks equals the combine without
    it (the combine kernel skips such chunks without reading their acc)."""
    acc, m, den = _partials(3)
    m[:, 1], den[:, 1] = K3.NEG_INF, 0.0        # chunk 1 masked in every row
    m[0, 3, 2], den[0, 3, 2] = K3.NEG_INF, 0.0  # and chunk 3 for one query
    got = K3.combine(acc, m, den, dtype)
    keep = [0, 2, 3]
    want = K3.combine(acc[:, keep], m[:, keep], den[:, keep], dtype)
    want[0, 2] = K3.combine(acc[0:1, [0, 2], 2:3], m[0:1, [0, 2], 2:3],
                            den[0:1, [0, 2], 2:3], dtype)[0, 0]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_combine_gives_zero_without_visible_positions():
    """A query whose every chunk is masked (as the attention leaves it:
    m = NEG_INF, den = 0, acc = 0) comes out 0; the others stay finite."""
    acc, m, den = _partials(4)
    m[1, :, 0, 2], den[1, :, 0, 2], acc[1, :, 0, 2] = K3.NEG_INF, 0.0, 0.0
    out = K3.combine(acc, m, den, torch.float32)
    assert torch.equal(out[1, 0, 2], torch.zeros(8))
    assert bool(torch.isfinite(out).all())
    assert bool((out.reshape(-1, 8).abs().sum(-1) > 0).sum() == out.numel() // 8 - 1)


# b, t, h, kh, hd, bf16, chunk_blocks -> the prefill path, on a card of 132 SMs
_PATHS = {
    "decode_b1": ((1, 1, 24, 8, 128, True, None), False),
    # the engine's 32 slots: 256 query tiles counted by ceil(t * g / 192), none full
    "decode_b32": ((32, 1, 24, 8, 128, True, None), False),
    "decode_b64_g48_mqa": ((64, 1, 48, 1, 128, True, None), False),
    "piece_t32": ((1, 32, 24, 8, 128, True, None), False),
    "piece_t32_b16": ((16, 32, 24, 8, 128, True, None), False),
    "piece_t32_g48_b2": ((2, 32, 48, 1, 128, True, None), False),
    "piece_t2048_g3": ((1, 2048, 24, 8, 128, True, None), True),
    "piece_t2048_g4": ((1, 2048, 32, 8, 128, True, None), True),
    "piece_t2048_g48_mqa": ((1, 2048, 48, 1, 128, True, None), True),
    "piece_t2048_b2": ((2, 2048, 24, 8, 128, True, None), True),
    "piece_t256_b4": ((4, 256, 24, 8, 128, True, None), False),   # 128 full tiles
    "piece_t256_b5": ((5, 256, 24, 8, 128, True, None), True),    # 160
    "tiles_just_short": ((1, 25343, 1, 1, 128, True, None), False),   # 131
    "tiles_just_enough": ((1, 25344, 1, 1, 128, True, None), True),   # 132
    "chunk_blocks_set": ((1, 2048, 24, 8, 128, True, 8), False),
    "fp32": ((1, 2048, 24, 8, 128, False, None), False),
    "hd80": ((1, 2048, 32, 32, 80, True, None), False),
    "hd96": ((1, 2048, 32, 32, 96, True, None), True),
}


@pytest.mark.parametrize("case", sorted(_PATHS))
def test_prefill_path_taken_by_shape(case):
    """K3's path from the call's host-side shapes alone: the prefill body
    when its full query tiles fill the card's SMs (bf16, a head dim it is
    built for, no explicit chunk_blocks), the split path otherwise: every
    decode step, every 32-token piece, an explicit chunk_blocks."""
    (b, t, h, kh, hd, bf16, cb), want = _PATHS[case]
    assert K3.takes_prefill_path(b, t, h, kh, hd, bf16, 132, cb) is want


# --------------------------------------------------- engine-level parity
@pytest.fixture(scope="module")
def models():
    return converted_models(seed=0)


def test_engine_greedy_parity_kernel_vs_gather(models):
    """The JAX kernel test's engine case: paged_kernel=True (K3's plain
    version) emits the gather engine's tokens on the SMOKE model with
    chunked prefill and staggered admission."""
    jmodel, params, tmodel = models
    cfg = tmodel.cfg
    rng = np.random.default_rng(11)
    reqs = [(rng.integers(0, cfg.vocab_size, size=n), m)
            for n, m in zip([3, 17, 6, 24, 2], [5, 3, 4, 3, 6])]

    def run(eng):
        tickets = [eng.submit(p, max_new_tokens=m) for p, m in reqs[:3]]
        eng.step()
        tickets += [eng.submit(p, max_new_tokens=m) for p, m in reqs[3:]]
        eng.run_until_drained()
        return [t.result().tolist() for t in tickets], eng.stats()

    knobs = dict(n_slots=2, cache_len=32, paged=True, block_size=8, prefill_chunk=8)
    want, _ = run(JaxEngine(jmodel, params, JaxEngineConfig(**knobs, paged_kernel=False)))
    for pk in (False, True):
        got, stats = run(ContinuousBatchingEngine(
            tmodel, EngineConfig(**knobs, paged_kernel=pk), device="cpu"))
        assert got == want
        assert stats["paged_kernel"] is pk
        assert stats["pool"]["free_blocks"] == stats["pool"]["n_usable_blocks"]


def test_engine_paged_kernel_requires_paged(mini):
    with pytest.raises(ValueError, match="paged_kernel"):
        EngineConfig(n_slots=1, cache_len=16,
                     paged_kernel=True)


@pytest.mark.parametrize("paged_kernel", [False, True])
def test_decoder_paged_step_matches_jax(models, paged_kernel):
    """`DecoderLM.paged_step` (the whole stack) against the JAX one: a
    chunked-prefill piece then a decode step over shared pools; logits at
    each row's last valid position agree, and the pools come back as the
    same tensors, written in place."""
    jmodel, params, tmodel = models
    cfg = tmodel.cfg
    rng = np.random.default_rng(5)
    jpools = jmodel.init_paged_caches(9, 4)
    tpools = tmodel.init_paged_caches(9, 4)
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 0]], np.int32)
    steps = [(np.array([0, 0], np.int32), np.array([6, 3], np.int32), 6),
             (np.array([6, 3], np.int32), np.array([1, 1], np.int32), 1)]
    for lengths, nv, t in steps:
        toks = rng.integers(0, cfg.vocab_size, size=(2, t)).astype(np.int32)
        jl, jpools = jmodel.paged_step(params, jpools, jnp.asarray(tables),
                                       jnp.asarray(lengths), jnp.asarray(toks),
                                       jnp.asarray(nv), paged_kernel=False)
        tl, out = tmodel.paged_step(tpools, tables, lengths, toks, nv,
                                    paged_kernel=paged_kernel)
        assert out.k_pool is tpools.k_pool
        np.testing.assert_allclose(to_numpy(tl), np.asarray(jl), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(to_numpy(tpools.k_pool)[:, 1:],
                                   np.asarray(jpools.k_pool)[:, 1:], **TOL)
