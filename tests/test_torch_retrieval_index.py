"""Port vs JAX: `DircRagIndex` build, scores and search on all five
compute paths, cosine and MIPS, INT4 and INT8, a doc count divisible by
the core count and one that is not, with the sensing-error channel off
and on (the JAX flips replayed through the port's flip hook)."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_parity import jax_flip_masks, to_numpy, unit_rows  # noqa: E402

from repro.core import error_model as jem  # noqa: E402
from repro.core import retrieval as jr  # noqa: E402
from repro_torch.core import error_model as tem  # noqa: E402
from repro_torch.core import retrieval as tr  # noqa: E402

DIM, K = 64, 5
ERR = dict(enabled=True, p_min=5e-3, p_max=4e-2, jitter_sigma=0.25, seed=1)


def _configs(path, metric, bits, error):
    kw = dict(bits=bits, metric=metric, n_cores=16, path=path, max_retries=2)
    je = jem.ErrorModelConfig(**ERR) if error else jem.ErrorModelConfig()
    te = tem.ErrorModelConfig(**ERR) if error else tem.ErrorModelConfig()
    return jr.RetrievalConfig(error=je, **kw), tr.RetrievalConfig(error=te, **kw)


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    docs = unit_rows(rng, n, DIM)
    queries = docs[[1, 7, n - 3]] + 0.05 * rng.normal(size=(3, DIM)).astype(np.float32)
    return docs, queries


def _cases():
    """Every path x metric x bits x error, with the doc count alternating
    between 256 (divisible by the 16 cores: hierarchical top-k) and 250
    (ragged: single comparator) so each path meets both. The reference
    path never reads the sensed planes, so it runs without errors only."""
    for path in tr.PATHS:
        for metric in ("cosine", "mips"):
            for bits in (4, 8):
                for error in (False, True):
                    if error and path == "reference":
                        continue
                    n = 256 if (metric == "cosine") == (bits == 8) else 250
                    yield path, metric, bits, n, error


@pytest.mark.parametrize("path,metric,bits,n,error", list(_cases()))
def test_index_matches_jax(path, metric, bits, n, error):
    jcfg, tcfg = _configs(path, metric, bits, error)
    docs, queries = _data(n, seed=bits + n)
    jidx = jr.DircRagIndex.build(jnp.asarray(docs), jcfg)
    tidx = tr.DircRagIndex.build(docs, tcfg, device="cpu")
    np.testing.assert_array_equal(to_numpy(tidx.planes), np.asarray(jidx.planes))
    np.testing.assert_array_equal(to_numpy(tidx.lut), np.asarray(jidx.lut))
    np.testing.assert_array_equal(to_numpy(tidx.doc_norms), np.asarray(jidx.doc_norms))
    np.testing.assert_array_equal(tidx.mapping, jidx.mapping)
    np.testing.assert_array_equal(to_numpy(tidx.flip_probs), np.asarray(jidx.flip_probs))
    assert tidx.storage_bytes() == jidx.storage_bytes()

    key = flips = None
    if error:
        key = jax.random.key(5)
        flips = jax_flip_masks(key, jidx.flip_probs, jidx.planes.shape,
                               jcfg.max_retries, jcfg.detect)
        jp, jstats = jidx.sensed_planes(key)
        tp, tstats = tidx.sensed_planes(flips=flips)
        np.testing.assert_array_equal(to_numpy(tp), np.asarray(jp))
        assert tstats == jstats and jstats["detected"] > 0

    want_s = np.asarray(jidx.scores(jnp.asarray(queries), key=key))
    got_s = to_numpy(tidx.scores(queries, flips=flips))
    if path == "reference":
        # fp32 matmul summed in another order than XLA's
        np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-7)
    else:
        # exact integer inner products, then the same fp32 epilogue
        np.testing.assert_array_equal(got_s, want_s)

    want = jidx.search(jnp.asarray(queries), K, key=key)
    got = tidx.search(queries, K, flips=flips)
    if path == "reference":
        # Ids are compared only at ranks whose score is separated from the
        # neighbouring ranks by far more than the 1e-5 summation-order
        # tolerance; near-tied scores may legitimately swap between the
        # two packages.
        np.testing.assert_allclose(to_numpy(got.scores), np.asarray(want.scores),
                                   rtol=1e-5, atol=1e-7)
        top = -np.sort(-want_s, axis=-1)[:, :K + 1]
        gap = -np.diff(top, axis=-1)                       # (b, K)
        apart = np.ones_like(gap, bool)
        apart[:, 1:] = (gap[:, :-1] > 1e-4) & (gap[:, 1:] > 1e-4)
        apart[:, 0] = gap[:, 0] > 1e-4
        assert apart.mean() >= 0.5
        np.testing.assert_array_equal(to_numpy(got.indices)[apart],
                                      np.asarray(want.indices)[apart])
        return
    np.testing.assert_array_equal(to_numpy(got.scores), np.asarray(want.scores))
    np.testing.assert_array_equal(to_numpy(got.indices), np.asarray(want.indices))


def test_error_channel_uses_generator_on_index_device():
    _, tcfg = _configs("bitserial", "cosine", 8, True)
    docs, queries = _data(128)
    idx = tr.DircRagIndex.build(docs, tcfg, device="cpu")
    clean, stats = idx.sensed_planes(None)
    assert clean is idx.planes and stats == {"detected": 0, "residual": 0}
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    s1 = idx.scores(queries, generator=g1)
    s2 = idx.scores(queries, generator=g2)
    assert torch.equal(s1, s2)
    noisy, stats = idx.sensed_planes(torch.Generator().manual_seed(4))
    assert stats["detected"] > 0 and not torch.equal(noisy, idx.planes)


def test_build_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _configs("int_exact", "cosine", 8, False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tr.DircRagIndex.build(_data(32)[0], tcfg)


def test_unknown_path_and_metric_raise():
    _, tcfg = _configs("int_exact", "cosine", 8, False)
    docs, queries = _data(32)
    for bad in (dict(path="nope"), dict(metric="l2")):
        idx = tr.DircRagIndex.build(docs, dataclasses.replace(tcfg, **bad), device="cpu")
        with pytest.raises(ValueError):
            idx.scores(queries)
