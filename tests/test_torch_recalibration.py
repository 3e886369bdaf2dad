"""Port vs JAX: per-macro device physics (`core/device_physics.py`) and
the online recalibration loop (`core/recalibration.py`).

The physics is numpy in both packages, so calibration maps, flip
probabilities, drift over a fake clock and the map re-extraction are
bit-equal. The controller is driven as `tests/test_recalibration.py`
drives it (a rotating drift on an injected clock), with the JAX sensing
flips replayed into the port shard by shard: it must fire on the same
shards at the same polls and leave the same counters."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_parity import (jax_flip_masks, same_sharded_image,  # noqa: E402
                           same_sharded_search, sharded_pair)

from repro.core import device_physics as jdp  # noqa: E402
from repro.core import error_model as jem  # noqa: E402
from repro.core import recalibration as jrc  # noqa: E402
from repro.core import remapping as jrm  # noqa: E402
from repro.data.synthetic import make_ir_dataset  # noqa: E402
from repro_torch.core import device_physics as tdp  # noqa: E402
from repro_torch.core import error_model as tem  # noqa: E402
from repro_torch.core import recalibration as trc  # noqa: E402

K = 5


def _docs(n=96, dim=32, seed=7):
    ds = make_ir_dataset("recal", n_docs=n, dim=dim, n_queries=8, n_clusters=8, seed=seed)
    return np.asarray(ds.doc_embeddings), np.asarray(ds.query_embeddings)


@pytest.mark.parametrize("jitter", [0.0, 2.0])
def test_calibration_maps_and_flip_probs_bit_equal(jitter):
    kw = dict(enabled=True, p_min=1e-4, p_max=1.5e-2, jitter_sigma=jitter, seed=5)
    jcfg, tcfg = jem.ErrorModelConfig(**kw), tem.ErrorModelConfig(**kw)
    for s in range(4):
        np.testing.assert_array_equal(tdp.shard_calibration_map(tcfg, s),
                                      jdp.shard_calibration_map(jcfg, s))
    emap = jdp.shard_calibration_map(jcfg, 1)
    mapping = jrm.build_mapping_for_map("error_aware", 8, emap)
    np.testing.assert_array_equal(tdp.flip_probs_for_map(mapping, emap),
                                  jdp.flip_probs_for_map(mapping, emap))
    assert tdp.weighted_exposure(mapping, emap) == jdp.weighted_exposure(mapping, emap)
    np.testing.assert_array_equal(tdp.stack_mappings(mapping, 3),
                                  jdp.stack_mappings(mapping, 3))


def test_drift_over_a_fake_clock_bit_equal():
    """Ageing, a random walk and a rotation, stepped over the same clock
    readings: true maps, channel probabilities and the ground-truth
    amplitude / phase agree at every step."""
    kw = dict(enabled=True, p_min=1e-3, p_max=3e-2, jitter_sigma=0.5, seed=3)
    drift = dict(enabled=True, amp_mu=0.01, amp_sigma=0.05, rotate_rate=0.3, seed=9)
    t = [0.0]
    jp = jdp.DevicePhysics(jem.ErrorModelConfig(**kw), 3, jdp.DriftConfig(**drift),
                           clock=lambda: t[0])
    tp = tdp.DevicePhysics(tem.ErrorModelConfig(**kw), 3, tdp.DriftConfig(**drift),
                           clock=lambda: t[0])
    mappings = np.stack([jrm.build_mapping_for_map("error_aware", 8, m)
                         for m in jp.true_maps()])
    for now in (0.0, 0.5, 1.7, 1.7, 4.25, 9.0):
        t[0] = now
        assert tp.advance() == jp.advance()
        np.testing.assert_array_equal(tp.true_maps(), jp.true_maps())
        np.testing.assert_array_equal(tp.flip_probs(mappings), jp.flip_probs(mappings))
        np.testing.assert_array_equal(tp.drift_amplitude(), jp.drift_amplitude())
        np.testing.assert_array_equal(tp.drift_phase(), jp.drift_phase())


def test_map_extraction_bit_equal():
    rng = np.random.default_rng(0)
    mapping = jrm.build_mapping("grouped", 8)
    counts = rng.integers(0, 50, size=(16, 8))
    trials = rng.integers(40, 80, size=(16,))
    for dim in (32, 512):
        np.testing.assert_array_equal(
            tdp.extract_map_from_counts(mapping, counts, trials, dim),
            jdp.extract_map_from_counts(mapping, counts, trials, dim))
    rates = np.linspace(0.0, 1.0, 11)
    np.testing.assert_array_equal(tdp.invert_detection_rate(rates, 64),
                                  jdp.invert_detection_rate(rates, 64))


def _drifting_pair(rate):
    docs, queries = _docs()
    t = [0.0]
    kw = dict(bits=8, path="bitserial", mapping="error_aware",
              error=dict(enabled=True, p_min=1e-4, p_max=1.5e-2, jitter_sigma=2.0,
                         seed=5),
              detect=True, max_retries=2)
    j, tt = sharded_pair(docs, 2, drift=dict(enabled=True, rotate_rate=rate, seed=11),
                         clock=lambda: t[0], **kw)
    return j, tt, queries, t


@pytest.mark.parametrize("cfg,rate", [
    (dict(window=4, trigger_ratio=1.02, min_detected=1), 0.02),
    (dict(window=2, trigger_ratio=1.0, min_detected=0, max_recals=1), 0.05),
])
def test_controller_fires_like_jax_under_replayed_flips(cfg, rate):
    """The drive of `tests/test_recalibration.py`: the clock steps one
    second per wave, each wave senses (JAX flips replayed per macro),
    searches and polls. Same shards fired at the same polls, same
    controller and index counters, same re-encoded images."""
    j, t, queries, clock = _drifting_pair(rate)
    jc = jrc.RecalibrationController(j, jrc.RecalibrationConfig(**cfg))
    tc = trc.RecalibrationController(t, trc.RecalibrationConfig(**cfg))
    key = jax.random.key(0)
    jfired, tfired = [], []
    for wave in range(24):
        clock[0] += 1.0
        j._refresh_channel()                # the probabilities this wave samples
        wkey = jax.random.fold_in(key, wave)
        flips = [jax_flip_masks(jax.random.fold_in(wkey, s), j.flip_probs[s],
                                j.planes[s].shape, 2, True) for s in range(2)]
        same_sharded_search(j, t, queries, key=wkey, flips=flips)
        jfired.append(jc.poll())
        tfired.append(tc.poll())
        assert tfired == jfired
    assert sum(map(len, tfired)) >= 1, "rotation drift never fired a recalibration"
    assert t.stats()["total_recals"] == sum(map(len, tfired))
    assert tc.stats() == jc.stats()
    assert t.stats() == j.stats()
    np.testing.assert_array_equal(tc._baseline, jc._baseline)
    same_sharded_image(j, t)
    np.testing.assert_array_equal(t.believed_maps, j.believed_maps)


def test_recalibrate_shard_matches_jax():
    """An online re-encode from the counters: the same believed map,
    mapping, channel probabilities and planes; searches between chunks
    keep the pre-recal top-k (p = 0 keeps sensing deterministic)."""
    emb, queries = _docs(n=64)
    err = dict(enabled=True, p_min=0.0, p_max=0.0)
    j, t = sharded_pair(emb, 2, bits=8, path="bitserial", mapping="error_aware",
                  error=err, detect=True, max_retries=2)
    g = torch.Generator().manual_seed(0)
    want = t.search(queries, K, generator=g)
    seen = []

    def on_chunk(lo, hi):
        got = t.search(queries, K, generator=g)
        assert torch.equal(got.indices, want.indices)
        assert torch.equal(got.scores, want.scores)
        seen.append((lo, hi))

    new_map = np.full((8, 8), 1e-3)
    new_map[0, :4] = 1e-2
    np.testing.assert_array_equal(t.recalibrate_shard(0, believed_map=new_map,
                                                      chunk_rows=7, on_chunk=on_chunk),
                                  j.recalibrate_shard(0, believed_map=new_map,
                                                      chunk_rows=7))
    assert len(seen) >= 4 and seen[-1][1] == t.capacity
    for _ in range(1 + len(seen)):          # as many sense events as t's searches
        j.search(jnp.asarray(queries), k=K, key=jax.random.key(0))
    same_sharded_image(j, t)
    np.testing.assert_array_equal(t.believed_maps, j.believed_maps)
    assert t.stats() == j.stats()
