"""Port vs JAX: the retrieval serving entry points — `build_rag_pipeline`,
`serve_rag` and the pipeline's sharded `add_docs` / `delete_docs` /
`retrieval_stats` (`repro_torch.launch.serve`, `serving.rag_pipeline`)
against `repro.launch.serve` at a small size (256 documents, dim 128, 4
shards); `serve_rag_open_loop` and the CLI's retrieval modes, on the
CPU."""
import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402

import numpy as np  # noqa: E402
from _torch_parity import to_numpy  # noqa: E402

from repro.launch import serve as jserve  # noqa: E402
from repro_torch.core.device_physics import DriftConfig  # noqa: E402
from repro_torch.core.recalibration import RecalibrationConfig  # noqa: E402
from repro_torch.core.retrieval import RetrievalConfig  # noqa: E402
from repro_torch.core.sharded_index import ShardedDircIndex  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.serving import RagPipeline  # noqa: E402

SIZE = dict(n_docs=256, n_shards=4, dim=128)


def _pair(**kw):
    return (jserve.build_rag_pipeline(**SIZE, **kw),
            tserve.build_rag_pipeline(**SIZE, device="cpu", **kw))


@pytest.mark.parametrize("path", ["int_exact", "kernel_bitserial"])
def test_build_rag_pipeline_and_search_match_jax(path):
    jp, tp = _pair(path=path)
    assert tp.doc_texts == jp.doc_texts
    assert isinstance(tp.index, ShardedDircIndex)
    np.testing.assert_array_equal(to_numpy(tp.index.planes), np.asarray(jp.index.planes))
    texts = tp.doc_texts[::17]
    jids, jscores = jp.search_batch(texts, 3)
    tids, tscores = tp.search_batch(texts, 3)
    np.testing.assert_array_equal(tids, np.asarray(jids))
    np.testing.assert_array_equal(tscores, np.asarray(jscores))
    assert (tids[:, 0] == np.arange(0, 256, 17)).all()     # self-retrieval
    results = tp.query_many(texts[:2], k=3)
    assert [int(r.doc_ids[0]) for r in results] == [0, 17]


def test_serve_rag_matches_jax():
    kw = dict(**SIZE, batch=16, n_queries=32, k=3, seed=1)
    jout = jserve.serve_rag(**kw)
    tout = tserve.serve_rag(**kw, device="cpu")
    assert tout["self_retrieval"] == jout["self_retrieval"] == 1.0
    assert tout["flushes"] == jout["flushes"] == 2
    assert tout["qps"] > 0 and tout["retrieval"] == jout["retrieval"]


def test_pipeline_updates_and_stats_match_jax():
    """add_docs / delete_docs through the pipelines, with the per-macro
    device physics on (and the controller attached): the same new ids,
    the new texts retrieve themselves, deleted ids never come back, and
    `retrieval_stats()` agrees (calibration, exposure, controller view)."""
    clock = lambda: 0.0  # noqa: E731
    jp, tp = _pair(sense_errors=True, drift_mag=1.0, recal=True, clock=clock)
    new = [f"fresh document {i}: " + " ".join(f"v{i * 7 + j}" for j in range(9))
           for i in range(6)]
    jids, tids = jp.add_docs(new), tp.add_docs(new)
    np.testing.assert_array_equal(tids, np.asarray(jids))
    assert tids.tolist() == list(range(256, 262))
    assert tp.doc_texts[256:] == new
    np.testing.assert_array_equal(tp.index.shard_loads(), np.asarray(jp.index.shard_loads()))
    ids, _ = tp.search_batch(new, 3)
    np.testing.assert_array_equal(ids, np.asarray(jp.search_batch(new, 3)[0]))
    assert (ids[:, 0] == tids).all()
    gone = tids[:3].tolist() + [0, 5]
    assert tp.delete_docs(gone) == jp.delete_docs(gone) == 5
    ids, _ = tp.search_batch(new + tp.doc_texts[:6], 3)
    np.testing.assert_array_equal(ids, np.asarray(jp.search_batch(new + jp.doc_texts[:6],
                                                                  3)[0]))
    assert not np.isin(ids, gone).any()
    st = tp.retrieval_stats()
    assert st == jp.retrieval_stats()
    assert st["live_docs"] == 256 + 6 - 5 and st["drift_enabled"]
    assert st["recalibration"]["window"] == RecalibrationConfig().window
    assert tp.add_docs([]).shape == (0,)
    tp.index.add_docs(tp.embedder.embed(["behind the pipeline's back"]))
    with pytest.raises(RuntimeError, match="out of sync"):
        tp.add_docs(["x"])


def test_monolithic_pipeline_refuses_device_physics():
    corpus = tserve.build_rag_pipeline(n_docs=32, n_shards=1, dim=64, device="cpu").doc_texts
    with pytest.raises(TypeError, match="n_shards"):
        RagPipeline(corpus, RetrievalConfig(), dim=64, drift=DriftConfig(enabled=True),
                    device="cpu")
    pipe = RagPipeline(corpus, RetrievalConfig(), dim=64, device="cpu")
    assert pipe.retrieval_stats() == {}
    with pytest.raises(ValueError, match="sense_errors"):
        tserve.build_rag_pipeline(n_docs=32, recal=True, device="cpu")


def test_open_loop_and_cli(tmp_path, capsys):
    out = tserve.serve_rag_open_loop(n_docs=64, n_shards=2, dim=64, max_batch=4,
                                     n_queries=24, offered_qps=2000.0, n_tenants=2,
                                     sense_errors=True, device="cpu")
    assert out["n_failed"] == 0 and out["n_queries"] == 24
    assert sum(k * v for k, v in out["batch_hist"].items()) == 24
    assert 0 < out["p50_ms"] <= out["p99_ms"]
    assert out["retrieval"]["total_senses"] > 0
    json.dumps(tserve._jsonable(out))
    report = tmp_path / "report.json"
    tserve.main(["--rag", "--device", "cpu", "--rag-docs", "64", "--n-shards", "2",
                 "--batch", "8", "--rag-queries", "16", "--path", "kernel_mxu",
                 "--json", str(report)])
    assert "self-retrieval 1.00" in capsys.readouterr().out
    assert json.loads(report.read_text())["self_retrieval"] == 1.0
    # an --arch no registry has, and no mode at all (the generation modes
    # are served: tests/test_torch_serve_generate.py)
    for argv in (["--arch", "no-such-arch"], []):
        with pytest.raises(SystemExit):
            tserve.main(argv)
    err = capsys.readouterr().err
    assert "unknown arch 'no-such-arch'" in err and "--arch is required" in err
