"""Port vs JAX: `ShardedDircIndex` updates and device physics — add /
delete / growth with tombstone reuse, `stats()`, the per-macro error
channel with the JAX package's own flips replayed shard by shard. The
online `recalibrate_shard` is in `test_torch_recalibration.py`."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_parity import jax_flip_masks, to_numpy  # noqa: E402
from _torch_parity import same_sharded_image, same_sharded_search, sharded_pair  # noqa: E402

from repro.data.synthetic import make_ir_dataset  # noqa: E402

K = 5


@pytest.fixture(scope="module")
def ds():
    d = make_ir_dataset(n_docs=256, dim=64, n_queries=8, n_clusters=16, seed=7)
    return np.asarray(d.doc_embeddings), np.asarray(d.query_embeddings)


def test_add_delete_grow_match_jax(ds):
    """The same updates on both: free slots and tombstones reused without
    growth, least-loaded placement, append-ordered ids never reused,
    growth when every macro is full, deleted ids never returned."""
    emb, queries = ds
    j, t = sharded_pair(emb[:62], 4, bits=8, path="int_exact")   # 2 slots free
    cap = t.capacity
    assert t.delete_docs([0, 1, 17]) == j.delete_docs([0, 1, 17]) == 3
    tid, jid = t.add_docs(queries[:5]), j.add_docs(jnp.asarray(queries[:5]))
    np.testing.assert_array_equal(tid, np.asarray(jid))
    assert tid.tolist() == list(range(62, 67)) and t.capacity == cap
    np.testing.assert_array_equal(t.shard_loads(), np.asarray(j.shard_loads()))
    same_sharded_image(j, t)
    res = same_sharded_search(j, t, queries[:5])
    np.testing.assert_array_equal(to_numpy(res.indices)[:, 0], tid)
    assert t.delete_docs(tid[:2].tolist()) == j.delete_docs(jid[:2].tolist()) == 2
    assert t.delete_docs(tid[:2].tolist()) == 0
    fill = np.tile(queries[5:6], (t.n_shards * t.capacity - t.n_docs + 2, 1))
    fid = t.add_docs(fill)
    np.testing.assert_array_equal(fid, np.asarray(j.add_docs(jnp.asarray(fill))))
    assert fid[0] == tid[-1] + 1 and t.capacity == j.capacity > cap
    same_sharded_image(j, t)
    res = same_sharded_search(j, t, queries)
    assert not np.isin(to_numpy(res.indices), tid[:2].tolist() + [0, 1, 17]).any()
    assert t.stats() == j.stats()


def _error_pair(emb, n_shards, path="bitserial", detect=True):
    err = dict(enabled=True, p_min=2e-3, p_max=4e-2, jitter_sigma=0.5, seed=5)
    return sharded_pair(emb, n_shards, bits=8, path=path, mapping="error_aware", error=err,
                  detect=detect, max_retries=2)


def _replayed_flips(j, key):
    """The JAX index's per-macro draws for `key`: shard s senses with
    `fold_in(key, s)` under its own probabilities."""
    cfg = j.config
    return [jax_flip_masks(jax.random.fold_in(key, s), j.flip_probs[s], j.planes[s].shape,
                           cfg.max_retries, cfg.detect) for s in range(j.n_shards)]


@pytest.mark.parametrize("path,detect", [("bitserial", True), ("kernel_bitserial", True),
                                         ("int_exact", False)])
def test_error_channel_replays_jax_flips(ds, path, detect):
    """Per-macro calibration and remapping equal; with the JAX flips
    replayed per shard the sensed planes, the top-k and every counter of
    `stats()` are equal, over several query waves."""
    emb, queries = ds
    j, t = _error_pair(emb[:128], 4, path=path, detect=detect)
    same_sharded_image(j, t)
    np.testing.assert_array_equal(t.believed_maps, j.believed_maps)
    assert any(not np.array_equal(t.mapping[0], t.mapping[s]) for s in range(1, 4))
    for wave in range(3):
        key = jax.random.key(wave)
        flips = _replayed_flips(j, key)
        if wave == 0:
            np.testing.assert_array_equal(to_numpy(t._sensed_planes(flips=flips)),
                                          np.asarray(j._sensed_planes(key)))
        same_sharded_search(j, t, queries, key=key, flips=flips)
    st = t.stats()
    assert st == j.stats()
    assert st["total_senses"] == 4 * 4          # 4 macros x 4 sense events
    assert (st["total_detected"] > 0) == detect
    np.testing.assert_array_equal(t._win_det_map, j._win_det_map)
    for s in range(4):
        np.testing.assert_array_equal(t.extract_error_map(s), j.extract_error_map(s))
    # no generator and no flips: clean planes, no counters move
    same_sharded_search(j, t, queries)
    assert t.stats() == j.stats()
