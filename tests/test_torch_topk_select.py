"""Port kernels K4 (`blockwise_topk`) and K5 (`score_matmul_cosine`) vs
the JAX Pallas kernels (interpret mode), their public wrappers in
`kernels.ops` and their oracles; and the port's `hierarchical_topk`,
whose local stage is K4, vs `repro.core.topk.hierarchical_topk`.

On the CPU the wrappers take the kernels' plain versions; the CUDA
kernels themselves are held against them on a card by
`tests/test_torch_cuda.py`."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_parity import int_codes, to_numpy, to_torch  # noqa: E402

from repro.core import topk as jtopk  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import topk_select as jsel  # noqa: E402
from repro_torch.core import topk as ttopk  # noqa: E402
from repro_torch.core.quantization import int_norm  # noqa: E402
from repro_torch.kernels import _build, ops, ref, score_matmul, topk_select  # noqa: E402


def _scores(seed, b, n):
    return np.random.default_rng(seed).normal(size=(b, n)).astype(np.float32)


@pytest.mark.parametrize("b,n,k", [(1, 512, 1), (3, 1200, 7), (2, 2048, 64)])
def test_local_topk_blocks_matches_jax(b, n, k):
    """The JAX kernel test's sweep: padding, K4, offsets and the merge."""
    s = _scores(n + k, b, n)
    jv, ji = jops.local_topk_blocks(jnp.asarray(s), k=k)
    tv, ti = ops.local_topk_blocks(to_torch(s), k)
    np.testing.assert_array_equal(to_numpy(ti), np.asarray(ji))
    np.testing.assert_array_equal(to_numpy(tv), np.asarray(jv))
    rv, ri = jax.lax.top_k(jnp.asarray(s), k)
    np.testing.assert_array_equal(to_numpy(ti), np.asarray(ri))
    np.testing.assert_array_equal(to_numpy(tv), np.asarray(rv))


def test_local_topk_blocks_ties():
    """All-zero scores: the lowest indices, in order."""
    tv, ti = ops.local_topk_blocks(torch.zeros((2, 1024)), 4)
    jv, ji = jops.local_topk_blocks(jnp.zeros((2, 1024)), k=4)
    np.testing.assert_array_equal(to_numpy(ti), np.asarray(ji))
    assert (to_numpy(ti) == np.arange(4)).all()


@pytest.mark.parametrize("b,n,block_n,k", [(2, 1024, 512, 5), (4, 2048, 128, 3),
                                           (3, 1536, 512, 64)])
def test_blockwise_topk_matches_jax_kernel(b, n, block_n, k):
    """K4's plain version vs the Pallas kernel in interpret mode and the
    oracle: block-local indices equal, values bit-equal. Every score is
    finite, where the TPU body and the oracle agree."""
    s = _scores(b * n + k, b, n)
    s[0, 10:40] = 0.25                      # ties inside one block
    jv, ji = jsel.blockwise_topk(jnp.asarray(s), k, interpret=True, block_n=block_n)
    tv, ti = topk_select.blockwise_topk(to_torch(s), k, block_n=block_n)
    assert ti.dtype == torch.int32 and tuple(ti.shape) == (b, n // block_n, k)
    np.testing.assert_array_equal(to_numpy(ti), np.asarray(ji))
    np.testing.assert_array_equal(to_numpy(tv), np.asarray(jv))
    ov, oi = jref.blockwise_topk(jnp.asarray(s), k, block_n)
    np.testing.assert_array_equal(to_numpy(ti), np.asarray(oi))
    rv, ri = ref.blockwise_topk(to_torch(s), k, block_n)
    np.testing.assert_array_equal(to_numpy(ri), np.asarray(oi))
    np.testing.assert_array_equal(to_numpy(rv), np.asarray(ov))


def test_blockwise_topk_neg_inf_tail_follows_the_oracle():
    """Blocks with fewer than k finite scores, the rest -inf (the sharded
    index's dead slots): the port returns the oracle's (`lax.top_k`'s)
    order, the -inf slots by index. The TPU body masks a taken score with
    -3e38, which outranks -inf, so it returns a taken index again."""
    s = np.full((2, 1024), -np.inf, np.float32)
    s[0, [5, 300]] = [0.5, 0.7]
    s[0, 600] = 0.1
    s[1, 1000] = -2.0
    k = 4
    ov, oi = jref.blockwise_topk(jnp.asarray(s), k, 512)
    tv, ti = topk_select.blockwise_topk(to_torch(s), k, block_n=512)
    np.testing.assert_array_equal(to_numpy(ti), np.asarray(oi))
    np.testing.assert_array_equal(to_numpy(tv), np.asarray(ov))
    assert to_numpy(ti)[0, 0].tolist() == [300, 5, 0, 1]
    for row in to_numpy(ti).reshape(-1, k):
        assert len(set(row.tolist())) == k          # no index twice
    _, tpu_i = jsel.blockwise_topk(jnp.asarray(s), k, interpret=True, block_n=512)
    assert any(len(set(r.tolist())) < k for r in np.asarray(tpu_i).reshape(-1, k))


@pytest.mark.parametrize("b,n,dim", [(2, 300, 128), (3, 257, 384), (72, 131, 48)])
def test_score_matmul_cosine_matches_jax(b, n, dim):
    """K5's plain version through `ops` vs the Pallas kernel through the
    JAX `ops`, at the JAX test's tolerance (rtol 1e-6); a ragged n and a
    zero-norm query row (the 1e-12 clamp)."""
    rng = np.random.default_rng(n)
    q, d = int_codes(rng, (b, dim)), int_codes(rng, (n, dim))
    q[-1] = 0
    dn = np.sqrt(np.sum(d.astype(np.float32) ** 2, -1))
    want = np.asarray(jops.score_matmul_cosine(jnp.asarray(q), jnp.asarray(d),
                                               jnp.asarray(dn)))
    got = ops.score_matmul_cosine(to_torch(q), to_torch(d), to_torch(dn))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, n)
    np.testing.assert_allclose(to_numpy(got), want, rtol=1e-6)
    assert (to_numpy(got)[-1] == 0).all()
    qn = int_norm(to_torch(q), keepdim=True)
    oracle = ref.score_matmul_cosine(to_torch(q), to_torch(d), qn, to_torch(dn)[None])
    np.testing.assert_array_equal(to_numpy(oracle), to_numpy(got))
    jo = jref.score_matmul_cosine(jnp.asarray(q), jnp.asarray(d),
                                  jnp.sqrt(jnp.sum(jnp.asarray(q, jnp.float32) ** 2, -1,
                                                   keepdims=True)),
                                  jnp.asarray(dn)[None])
    np.testing.assert_allclose(to_numpy(got), np.asarray(jo), rtol=1e-6)
    got1 = ops.score_matmul_cosine(to_torch(q[0]), to_torch(d), to_torch(dn))
    np.testing.assert_array_equal(to_numpy(got1), to_numpy(got)[0])


def _hier_scores(shape, k, fill):
    """Scores for the hierarchical top-k: "rounded" (ties) with -inf
    slots, "all_equal", "dead_cores" (-inf tails: most cores hold fewer
    than k live scores, some none) or "signed_zeros" (+0.0 and -0.0 only)."""
    rng = np.random.default_rng(k)
    rows, n = int(np.prod(shape[:-1])), shape[-1]
    if fill == "all_equal":
        s = np.full((rows, n), 0.5, np.float32)
    elif fill == "signed_zeros":
        s = np.where(rng.random((rows, n)) < 0.5, np.float32(0.0), np.float32(-0.0))
    else:
        s = np.round(_scores(k, rows, n), 1)
        s[..., 7::13] = -np.inf
        if fill == "dead_cores":   # ~8 live scores a row, all in its second half
            live = rng.random((rows, n)) < 16 / n
            live[:, : n // 2] = False
            s = np.where(live, s, -np.inf)
    return s.astype(np.float32).reshape(shape)


@pytest.mark.parametrize("shape,k,n_cores,fill", [
    ((4, 2048), 5, 16, "rounded"), ((2, 3, 1024), 3, 16, "rounded"),
    ((8, 512), 40, 16, "rounded"),                       # k > per
    ((2, 8192), 3, 16, "rounded"), ((8, 2048), 3, 16, "rounded"),   # the path's shapes
    ((8, 4096), 3, 16, "rounded"),
    ((4, 2048), 5, 16, "all_equal"), ((8, 512), 40, 16, "all_equal"),
    ((8, 2048), 3, 16, "dead_cores"), ((3, 512), 40, 16, "dead_cores"),
    ((8, 2048), 3, 16, "signed_zeros"), ((4, 512), 40, 16, "signed_zeros"),
])
def test_hierarchical_topk_matches_jax(monkeypatch, shape, k, n_cores, fill):
    """The port's hierarchical top-k (one `hierarchical_select` call) and
    that function's plain version vs the JAX package's, values and ids
    exact; CPU tensors never reach the kernel library or its launch count."""
    def refuse():
        raise AssertionError("CPU tensors must not load the CUDA library")

    monkeypatch.setattr(_build, "load_library", refuse)
    monkeypatch.setattr(topk_select, "LAUNCHES", 0)
    s = _hier_scores(shape, k, fill)
    jt = jtopk.hierarchical_topk(jnp.asarray(s), k, n_cores=n_cores)
    tt = ttopk.hierarchical_topk(to_torch(s), k, n_cores=n_cores)
    np.testing.assert_array_equal(to_numpy(tt.indices), np.asarray(jt.indices))
    np.testing.assert_array_equal(to_numpy(tt.scores).view(np.uint32),
                                  np.asarray(jt.scores).view(np.uint32))
    assert tt.indices.dtype == torch.int32
    rv, ri = topk_select.hierarchical_select_ref(to_torch(s.reshape(-1, shape[-1])), k,
                                                 n_cores)
    np.testing.assert_array_equal(to_numpy(ri), np.asarray(jt.indices).reshape(ri.shape))
    np.testing.assert_array_equal(to_numpy(rv).view(np.uint32),
                                  np.asarray(jt.scores).reshape(rv.shape).view(np.uint32))
    assert topk_select.LAUNCHES == 0 and score_matmul.COSINE_LAUNCHES == 0


def test_blockwise_topk_signed_zeros_follow_the_oracle():
    """`lax.top_k` ranks +0.0 above -0.0 (XLA's total order), so K4's plain
    version returns the +0.0 slots first, each sign in index order; the
    TPU body compares with ==, for which the two are equal."""
    rng = np.random.default_rng(5)
    s = np.where(rng.random((3, 1024)) < 0.5, np.float32(0.0), np.float32(-0.0))
    k = 40
    ov, oi = jref.blockwise_topk(jnp.asarray(s), k, 256)
    tv, ti = topk_select.blockwise_topk(to_torch(s), k, block_n=256)
    np.testing.assert_array_equal(to_numpy(ti), np.asarray(oi))
    np.testing.assert_array_equal(to_numpy(tv).view(np.uint32), np.asarray(ov).view(np.uint32))
    blk = s[0, :256]
    want = np.concatenate([np.flatnonzero(~np.signbit(blk)), np.flatnonzero(np.signbit(blk))])
    assert to_numpy(ti)[0, 0].tolist() == want[:k].tolist()
    _, tpu_i = jsel.blockwise_topk(jnp.asarray(s), k, interpret=True, block_n=256)
    assert (np.asarray(tpu_i) == np.arange(k)).all()


def test_k4_wrapper_validates_inputs():
    with pytest.raises(TypeError):
        topk_select.blockwise_topk(torch.zeros((2, 512), dtype=torch.float64), 3)
    with pytest.raises(ValueError):
        topk_select.blockwise_topk(torch.zeros((2, 500)), 3)
    with pytest.raises(ValueError):
        topk_select.blockwise_topk(torch.zeros((2, 256)), 300, block_n=256)
    with pytest.raises(ValueError):
        topk_select.blockwise_topk(torch.zeros(512), 3)
    with pytest.raises(ValueError):                       # n % n_cores != 0
        topk_select.hierarchical_select(torch.zeros((2, 500)), 3, 16)
    with pytest.raises(ValueError):
        topk_select.hierarchical_select(torch.zeros((2, 512)), 0, 16)
    with pytest.raises(TypeError):
        topk_select.hierarchical_select(torch.zeros((2, 512), dtype=torch.float64), 3, 16)
    with pytest.raises(TypeError):
        ttopk.local_topk(torch.zeros((2, 512), dtype=torch.float64), 3)
    with pytest.raises(TypeError):
        score_matmul.score_matmul_cosine(torch.zeros((2, 32), dtype=torch.int8),
                                         torch.zeros((4, 32), dtype=torch.int8),
                                         torch.ones((2, 1), dtype=torch.float64),
                                         torch.ones((1, 4)))
    with pytest.raises(ValueError):
        score_matmul.score_matmul_cosine(torch.zeros((2, 32), dtype=torch.int8),
                                         torch.zeros((4, 32), dtype=torch.int8),
                                         torch.ones((2,)), torch.ones((1, 4)))
    with pytest.raises(ValueError, match="dim <= 1024"):      # past fp32's exact range
        ops.score_matmul_cosine(torch.zeros((2, 1040), dtype=torch.int8),
                                torch.zeros((4, 1040), dtype=torch.int8), torch.ones(4))
