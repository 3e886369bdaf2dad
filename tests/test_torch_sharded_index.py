"""Port vs JAX: `ShardedDircIndex` — every compute path at n_shards 1, 3
and 4 (integer paths bit-equal in scores and ids, the reference path
allclose), the MIPS metric, a ragged corpus, the image and
`storage_bytes()`, the parallelism modes and the refusals. Updates and
the error channel are in `test_torch_sharded_updates.py`."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_parity import (retrieval_configs, same_sharded_image,  # noqa: E402
                           same_sharded_search, sharded_pair, to_numpy)

from repro.data.synthetic import make_ir_dataset  # noqa: E402
from repro_torch.core import retrieval as tr  # noqa: E402
from repro_torch.core import sharded_index as tsi  # noqa: E402
from repro_torch.kernels import topk_select  # noqa: E402

K = 5


@pytest.fixture(scope="module")
def ds():
    d = make_ir_dataset(n_docs=256, dim=64, n_queries=8, n_clusters=16, seed=7)
    return np.asarray(d.doc_embeddings), np.asarray(d.query_embeddings)


@pytest.mark.parametrize("path", tr.PATHS)
@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_every_path_matches_jax(ds, path, n_shards):
    """Scores (S, b, cap) and top-k, port vs JAX; n_shards 3 leaves a
    capacity (86) the 16 cores do not divide (single comparator), 1 and
    4 fold (hierarchical, K4's plain version)."""
    emb, queries = ds
    j, t = sharded_pair(emb, n_shards, bits=8, metric="cosine", path=path)
    same_sharded_image(j, t)
    exact = path != "reference"
    js = np.asarray(j.scores(jnp.asarray(queries)))
    ts = to_numpy(t.scores(queries))
    assert ts.shape == (n_shards, len(queries), t.capacity)
    if exact:
        np.testing.assert_array_equal(ts, js)
    else:
        np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-6)
    tres = same_sharded_search(j, t, queries, exact=exact)
    mono = tr.DircRagIndex.build(emb, retrieval_configs(path=path)[1], device="cpu").search(
        queries, K)
    np.testing.assert_array_equal(to_numpy(tres.indices), to_numpy(mono.indices))


def test_mips_metric_and_ragged_corpus(ds):
    emb, queries = ds
    j, t = sharded_pair(emb, 4, bits=8, metric="mips", path="int_exact")
    same_sharded_search(j, t, queries)
    for n_shards in (4, 3):                       # 253 docs: ragged macros
        j, t = sharded_pair(emb[:253], n_shards, bits=8, path="int_exact")
        same_sharded_image(j, t)
        same_sharded_search(j, t, queries)
    # more neighbours than one macro holds, and a 1-D query
    j, t = sharded_pair(emb[:40], 4, bits=4, path="bitserial")
    same_sharded_search(j, t, queries, k=12)
    same_sharded_search(j, t, queries[0], k=3)


def test_parallelism_and_refusals(ds, monkeypatch):
    """"vmap" and "map" are one batched macro axis, and so is "shard_map"
    in a process with no process group (one device: the reference's vmap
    fallback); the mesh parts are in test_torch_mesh_retrieval.py. A CPU
    search never launches K4. Bad arguments raise ValueError."""
    emb, queries = ds
    _, tcfg = retrieval_configs(path="int_exact")
    monkeypatch.setattr(topk_select, "LAUNCHES", 0)
    a = tsi.ShardedDircIndex.build(emb, tcfg, n_shards=4, parallelism="vmap",
                                   device="cpu").search(queries, K)
    for mode in ("map", "shard_map"):
        idx = tsi.ShardedDircIndex.build(emb, tcfg, n_shards=4, parallelism=mode,
                                         device="cpu")
        assert idx.mesh is None and idx._macro_block() is None
        b = idx.search(queries, K)
        assert torch.equal(a.indices, b.indices) and torch.equal(a.scores, b.scores)
    assert topk_select.LAUNCHES == 0
    with pytest.raises(ValueError, match="metric"):
        tsi.make_distributed_searcher(None, K, metric="l2")
    with pytest.raises(ValueError):
        tsi.ShardedDircIndex.build(emb, tcfg, parallelism="pmap", device="cpu")
    with pytest.raises(ValueError):
        tsi.ShardedDircIndex.build(emb, tcfg, n_shards=0, device="cpu")
    idx = tsi.ShardedDircIndex.build(emb[:8], tcfg, n_shards=2, device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        idx.search(queries, 9)
    with pytest.raises(ValueError, match="dim"):
        idx.add_docs(np.zeros((1, 4), np.float32))
    assert dataclasses.is_dataclass(idx)
