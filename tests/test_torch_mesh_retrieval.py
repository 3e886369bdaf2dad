"""Retrieval over a device mesh, on 2 and 4 spawned gloo ranks
(`_torch_dist`), against the JAX package in this process:

  * `ShardedDircIndex(parallelism="shard_map")` over the macro mesh on
    every compute path at n_shards 4 (each rank scores its block, an
    all-gather returns all of them; the kernel paths take the vmap
    route, as in the reference) and 3 (the mesh does not divide it: the
    vmap route), against the JAX index (`vmap`): scores and ids of every
    rank equal the JAX index's (bit for bit on the integer paths,
    allclose on the fp32 `reference` path);
  * `make_distributed_searcher` / `shard_index_arrays` on
    `test_sharding.py`'s 512 x 128, k 8 case, over the macro mesh and a
    2-D (data, model) mesh: ids equal the JAX searcher's on a 1-device
    JAX mesh and the flat top-k, scores bit-equal, cosine and MIPS; and a
    corpus of repeated codes, so equal scores straddle the shards: the
    lower id comes first, as in `lax.top_k`; over 3 ranks, which do not
    divide its 512 docs, both refuse with a ValueError, as the
    reference's `shard_map` does.
The ranks of each world size run while the JAX side computes."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_dist import Ranks, retrieval_suite, uneven_refusals  # noqa: E402
from _torch_parity import retrieval_configs  # noqa: E402

from repro.core import quantization as jq  # noqa: E402
from repro.core import sharded_index as jsi  # noqa: E402
from repro.data.synthetic import make_ir_dataset  # noqa: E402

K = 5
SEARCH_K = 8
WORLDS = (2, 4)
PATHS = ("reference", "int_exact", "bitserial", "kernel_bitserial", "kernel_mxu")
CASES = [(p, "cosine", s) for p in PATHS for s in (4, 3)] + [("int_exact", "mips", 4)]


def _corpora():
    """name -> (int8 codes (512, 128), integer norms) and the int8 queries
    of `test_sharding.py`'s case; "ties" repeats 64 codes 8 times, so
    every top score is shared by docs on every shard."""
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(512, 128)).astype(np.float32)
    docs = jq.quantize(jnp.asarray(emb), bits=8)
    q = jq.quantize_query(jnp.asarray(
        emb[:4] + 0.05 * rng.normal(size=(4, 128)).astype(np.float32))).values
    tie = jq.quantize(jnp.asarray(np.tile(emb[:64], (8, 1))), bits=8)
    return ({"rand": (docs.values, jq.doc_int_norms(docs)),
             "ties": (tie.values, jq.doc_int_norms(tie))}, q)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX results, {world: every rank's results, "uneven": the 3 ranks' refusals})."""
    d = make_ir_dataset(n_docs=256, dim=64, n_queries=8, n_clusters=16, seed=7)
    emb, queries = np.asarray(d.doc_embeddings), np.asarray(d.query_embeddings)
    corpora, q = _corpora()
    np_corpora = {k: (np.asarray(v), np.asarray(n)) for k, (v, n) in corpora.items()}
    ranks = {w: Ranks(retrieval_suite, w, str(tmp_path_factory.mktemp(f"w{w}") / "store"),
                      (emb, queries, CASES, K),
                      (np_corpora, np.asarray(q), SEARCH_K, 2))
             for w in WORLDS}
    codes, norms = np_corpora["rand"]
    ranks["uneven"] = Ranks(uneven_refusals, 3, str(tmp_path_factory.mktemp("w3") / "store"),
                            codes, norms, np.asarray(q), SEARCH_K)
    want = {"index": {}, "searcher": {}}
    for path, metric, n_shards in CASES:
        jcfg, _ = retrieval_configs(bits=8, metric=metric, path=path)
        j = jsi.ShardedDircIndex.build(jnp.asarray(emb), jcfg, n_shards=n_shards,
                                       parallelism="vmap")
        res = j.search(jnp.asarray(queries), k=K)
        want["index"][(path, metric, n_shards)] = (
            np.asarray(j.scores(jnp.asarray(queries))), np.asarray(res.scores),
            np.asarray(res.indices))
    mesh = jax.make_mesh((1,), ("macro",))
    for name, (codes, norms) in corpora.items():
        dv, nv = jsi.shard_index_arrays(mesh, codes, norms)
        for metric in ("cosine", "mips"):
            res = jsi.make_distributed_searcher(mesh, k=SEARCH_K, metric=metric)(q, dv, nv)
            ip = jq.int_inner_product(q, codes).astype(jnp.float32)
            if metric == "cosine":
                qn = jnp.sqrt(jnp.sum(q.astype(jnp.float32) ** 2, -1, keepdims=True))
                ip = ip / jnp.maximum(qn * norms[None, :], 1e-12)
            flat = jax.lax.top_k(ip, SEARCH_K)
            want["searcher"][(name, metric)] = (np.asarray(res.scores),
                                                np.asarray(res.indices),
                                                np.asarray(flat[0]), np.asarray(flat[1]))
    return want, {w: r.results(timeout=150) for w, r in ranks.items()}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_shard_map_index_matches_jax(runs, world, case):
    want, got = runs
    j_scores, j_top, j_ids = want["index"][case]
    path, _, n_shards = case
    split = n_shards % world == 0 and path not in ("kernel_bitserial", "kernel_mxu")
    for rank, res in enumerate(got[world]):
        block, scores, top, ids = res["index"][case]
        per = n_shards // world
        assert block == ((rank * per, (rank + 1) * per) if split else None)
        if path == "reference":   # fp32 matmuls summed in another order than XLA's
            np.testing.assert_allclose(scores, j_scores, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(top, j_top, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(scores, j_scores)
            np.testing.assert_array_equal(top, j_top)
        np.testing.assert_array_equal(ids, j_ids)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("corpus", ["rand", "ties"])
@pytest.mark.parametrize("metric", ["cosine", "mips"])
def test_distributed_searcher_matches_jax(runs, world, corpus, metric):
    want, got = runs
    j_scores, j_ids, flat_scores, flat_ids = want["searcher"][(corpus, metric)]
    np.testing.assert_array_equal(j_ids, flat_ids)
    for res in got[world]:
        s = res["searcher"]
        assert s["launches"] == 0          # the CPU runs the kernels' plain versions
        for mesh in ("macro", "local"):
            scores, ids = s[(corpus, mesh, metric)]
            np.testing.assert_array_equal(ids, j_ids)
            np.testing.assert_array_equal(scores, j_scores)
            np.testing.assert_array_equal(scores, flat_scores)
            if metric == "cosine":
                whole = s[(corpus, mesh, "whole")]
                np.testing.assert_array_equal(whole[1], j_ids)
                np.testing.assert_array_equal(whole[0], j_scores)
    if corpus == "ties":   # each top score is shared by 8 docs, one a 64-doc period
        ids = got[world][0]["searcher"][(corpus, "macro", metric)][1]
        assert (ids % 64 == ids[:, :1] % 64).all() and (np.diff(ids) > 0).all()


def test_distributed_searcher_refuses_uneven_split(runs):
    _, got = runs
    for res in got["uneven"]:
        assert res == ["512 docs do not divide over the 3 ranks of mesh axes ('macro',)"] * 2
