"""`examples_torch/quickstart.py` against `examples/quickstart.py` on the
same 4096 x 512 corpus: the clean P@5 and every query's top-5 ids equal;
the noisy P@5 equal when the reference's flips from `jax.random.key(0)`
are replayed through the twin's `flips=` hook; the twin's own generator
within the reference's spread over a few keys; the simulator lines
equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_examples import one_thread, printed, reference, twin
from _torch_parity import jax_flip_masks
from repro.core.retrieval import DircRagIndex as JaxIndex
from repro.core.retrieval import RetrievalConfig as JaxConfig
from repro.core.error_model import ErrorModelConfig as JaxErrors
from repro.core.topk import precision_at_k as jax_p_at_k

SPREAD_KEYS = 4          # the reference's keys 0 .. 3
NOISY = dict(bits=8, path="bitserial", mapping="error_aware", detect=True, max_retries=3)


@pytest.fixture(scope="module")
def runs():
    """The reference's lines; the JAX noisy index's P@5 under keys 0 ..
    SPREAD_KEYS - 1 and its key-0 flips; the twin with those flips and
    with its own generator, both (return value, lines)."""
    qs = twin("quickstart")
    _, ref_lines = printed(reference("quickstart").main)
    ds = qs.dataset()
    jidx = JaxIndex.build(jnp.asarray(ds.doc_embeddings), JaxConfig(
        error=JaxErrors(enabled=True, p_min=5e-3, p_max=8e-2), **NOISY))
    spread = [float(jax_p_at_k(jidx.search(jnp.asarray(ds.query_embeddings), k=5,
                                           key=jax.random.key(i)).indices,
                               jnp.asarray(ds.relevant), 5)) for i in range(SPREAD_KEYS)]
    flips = jax_flip_masks(jax.random.key(0), np.asarray(jidx.flip_probs), jidx.planes.shape,
                           3, True)
    clean = JaxIndex.build(jnp.asarray(ds.doc_embeddings),
                           JaxConfig(bits=8, metric="cosine", path="int_exact"))
    ids = np.asarray(clean.search(jnp.asarray(ds.query_embeddings), k=5).indices)
    with one_thread():
        return {"ref": ref_lines, "spread": spread, "ids": ids,
                "replayed": printed(qs.main, ["--device", "cpu"], flips=flips),
                "own": printed(qs.main, ["--device", "cpu"])}


def test_clean_p5_and_ids_identical(runs):
    out, lines = runs["replayed"]
    assert lines[:5] == runs["ref"][:5]
    assert lines[2].startswith("   P@5 = ") and lines[3].startswith("   top-5 doc ids")
    np.testing.assert_array_equal(np.asarray(out["ids"]), runs["ids"])
    assert out["ids0"] == runs["ids"][0].tolist()


def test_noisy_p5_identical_under_replayed_flips(runs):
    out, lines = runs["replayed"]
    assert lines[5] == runs["ref"][5]
    assert "Sigma-D detection" in lines[5]
    assert out["p5_noisy"] == pytest.approx(runs["spread"][0], abs=1e-6)


def test_own_generator_within_the_reference_spread(runs):
    """P@5 over 64 queries moves in steps of 1/320 from key to key: the
    twin's draw from its own generator lies within 4 sample standard
    deviations of the reference's mean over SPREAD_KEYS keys, plus one
    step (when written, keys 0-3 gave 0.700 / 0.694 / 0.684 / 0.703,
    a tolerance of ~0.037)."""
    spread = np.asarray(runs["spread"])
    tol = 4 * spread.std(ddof=1) + 1 / 320
    assert 0 < tol < 0.1
    assert abs(runs["own"][0]["p5_noisy"] - spread.mean()) <= tol


def test_simulator_lines_identical(runs):
    for run in ("replayed", "own"):
        out, lines = runs[run]
        assert lines[6:] == runs["ref"][6:]
        assert len(lines) == len(runs["ref"]) == 10
    assert f"   database: {out['db_mb']:.2f} MB INT8" == lines[7]
