"""Port vs JAX: generation serving from the serving CLI — `launch.serve`'s
`serve_rag_open_loop_generate` (Poisson arrivals -> async retrieval ->
continuous-batching decode over a 2-replica fleet with the tiered prefix
cache and the SLO controller), `serve` and the CLI's generation flags.

Both packages serve the same tiny pipeline (64 documents over 2 shards,
dim 64) with the fp32 phi4-mini SMOKE model under the same (converted)
weights. Finish order depends on timing, so each query's retrieved doc
ids and greedy tokens are keyed by the query text: they must be equal,
and so must the report's key set. The CLI runs end to end on the CPU;
the ssm / hybrid / audio architectures are held against the JAX drivers
here and in tests/test_torch_serve_families.py."""
import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402

import numpy as np  # noqa: E402
from _torch_parity import converted_models  # noqa: E402
from _torch_ssm import check_serve, converted_pipelines  # noqa: E402

from repro.launch import serve as jserve  # noqa: E402
from repro.serving import GenerationEngine as JaxGenerationEngine  # noqa: E402
from repro.serving import SLOConfig as JaxSLOConfig  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.serving import EngineConfig, GenerationEngine, SLOConfig  # noqa: E402

SIZE = dict(n_docs=64, n_shards=2, dim=64)
ENGINE = dict(n_slots=2, paged=True, block_size=8, prefill_chunk=16, retain_blocks=8,
              host_blocks=16)
RUN = dict(max_batch=4, max_wait_ms=2.0, n_tenants=2, offered_qps=400.0, n_queries=12,
           k=2, max_new_tokens=3, n_replicas=2, hi_pri_tenants=1, seed=1)
SLO = dict(ttft_p95_ms=1e4, interval_s=0.05, min_samples=2)


def _recording(pipe):
    """Wrap the pipeline's decode_engine so that every ticket its engine
    (or fleet) hands out is kept."""
    tickets, make = [], pipe.decode_engine

    def decode_engine(*a, **kw):
        eng = make(*a, **kw)
        submit = eng.submit

        def recorded(*sa, **skw):
            tickets.append(submit(*sa, **skw))
            return tickets[-1]

        eng.submit = recorded
        return eng

    pipe.decode_engine = decode_engine
    return tickets


def _by_query(tickets):
    out = {}
    for t in tickets:
        if getattr(t, "retrieval", None) is not None:   # not a warm-up request
            got = (np.asarray(t.retrieval.doc_ids).tolist(), list(t.tokens))
            assert out.setdefault(t.retrieval.text, got) == got
    return out


@pytest.fixture(scope="module")
def runs():
    jmodel, params, tmodel = converted_models(seed=0)
    jpipe = jserve.build_rag_pipeline(**SIZE)
    jpipe.engine = JaxGenerationEngine(jmodel, params)
    tpipe = tserve.build_rag_pipeline(**SIZE, device="cpu")
    tpipe.engine = GenerationEngine(tmodel, device="cpu")
    jt, tt = _recording(jpipe), _recording(tpipe)
    want = jserve.serve_rag_open_loop_generate(
        **RUN, config=JaxEngineConfig(**ENGINE, paged_kernel=False),
        slo=JaxSLOConfig(**SLO), pipe=jpipe)
    got = tserve.serve_rag_open_loop_generate(
        **RUN, config=EngineConfig(**ENGINE, paged_kernel=True), slo=SLOConfig(**SLO),
        pipe=tpipe)
    return want, got, _by_query(jt), _by_query(tt)


def test_open_loop_generate_ids_and_tokens_match_jax(runs):
    want, got, jq, tq = runs
    assert tq == jq and len(tq) >= 4
    assert got["n_failed"] == want["n_failed"] == 0
    assert got["n_chain_failed"] == 0
    assert got["n_finished"] == got["n_queries"] == RUN["n_queries"]
    assert got["n_tokens"] == want["n_tokens"] == RUN["n_queries"] * RUN["max_new_tokens"]
    assert sum(got["per_replica_submits"]) == RUN["n_queries"]
    for key in ("ttft_p50_ms", "ttft_p95_ms", "p50_ms", "p95_ms", "p99_ms"):
        assert np.isfinite(got[key]) and got[key] > 0, key


def test_open_loop_generate_report_keys_match_jax(runs):
    want, got, _, _ = runs
    assert set(got) == set(want)
    assert set(got["pool"]) == set(want["pool"])
    assert set(got["slo"]) == set(want["slo"])
    assert got["paged_kernel"] is True and want["paged_kernel"] is False
    assert (got["retain_blocks"], got["host_blocks"]) == (8, 16)
    assert got["n_replicas"] == 2 and got["hi_pri_tenants"] == 1
    json.dumps(tserve._jsonable(got))


def test_sum_pools_matches_jax():
    pools = [dict(n_prefix_hits=3, n_prefix_misses=1, n_device_hits=2, n_host_hits=1,
                  block_size=8, free_blocks=5, prefix_hit_rate=0.75,
                  device_hit_rate=0.5, host_hit_rate=0.25),
             dict(n_prefix_hits=0, n_prefix_misses=4, n_device_hits=0, n_host_hits=0,
                  block_size=8, free_blocks=7, prefix_hit_rate=0.0,
                  device_hit_rate=0.0, host_hit_rate=0.0)]
    assert tserve._sum_pools(pools) == jserve._sum_pools(pools)
    assert tserve._sum_pools(pools)["prefix_hit_rate"] == 3 / 8


def test_serve_and_cli_generation_modes(tmp_path, capsys):
    out = tserve.serve("phi4-mini-3.8b", batch=2, prompt_len=8, new_tokens=4, device="cpu")
    assert out["tokens"].shape == (2, 4) and out["tok_per_s"] > 0
    assert out["tokens"].max() < 512
    report = tmp_path / "report.json"
    tserve.main(["--rag", "--open-loop", "--generate", "--device", "cpu", "--rag-docs", "32",
                 "--n-shards", "2", "--batch", "4", "--rag-queries", "6",
                 "--offered-qps", "300", "--new-tokens", "3", "--paged", "--paged-kernel",
                 "--n-slots", "2", "--block-size", "8", "--prefill-chunk", "16",
                 "--retain-blocks", "8", "--host-blocks", "16", "--n-replicas", "2",
                 "--max-imbalance", "1", "--slo-ttft-ms", "5000", "--slo-interval-s",
                 "0.05", "--hi-pri-tenants", "1", "--json", str(report)])
    text = capsys.readouterr().out
    assert "finished 6/6 requests" in text and "fleet: 2 replicas" in text
    rep = json.loads(report.read_text())
    assert rep["n_failed"] == 0 and rep["n_replicas"] == 2 and "slo" in rep
    assert rep["pool"]["n_usable_blocks"] > 0 and rep["host_blocks"] == 16
    tserve.main(["--arch", "phi4-mini-3.8b", "--device", "cpu", "--batch", "2",
                 "--prompt-len", "4", "--new-tokens", "2"])
    assert "generated (2, 2) tokens" in capsys.readouterr().out


def test_unported_arch_names_its_roadmap_item(capsys, monkeypatch):
    """The ssm, hybrid and audio archs, refused before, are served:
    `serve("mamba2-2.7b")` gives the JAX engine's tokens on the same
    prompts with the same converted weights; `build_rag_pipeline(arch=
    "zamba2-2.7b")` attaches the hybrid smoke model, and with converted
    weights its `query_many` answers are the JAX pipeline's; `--rag
    --open-loop --generate --arch whisper-small` runs to the end. An arch
    no registry has is a CLI error naming the registry's."""
    check_serve("mamba2-2.7b", monkeypatch)
    jpipe, tpipe = converted_pipelines("zamba2-2.7b", n_docs=8, n_shards=2, dim=32,
                                       max_prompt_len=24)
    want = jpipe.query_many(tpipe.doc_texts[:2], k=2, max_new_tokens=2)
    got = tpipe.query_many(tpipe.doc_texts[:2], k=2, max_new_tokens=2)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.answer_tokens, w.answer_tokens)
    tserve.main(["--rag", "--open-loop", "--generate", "--arch", "whisper-small",
                 "--device", "cpu", "--rag-docs", "8", "--n-shards", "2", "--batch", "2",
                 "--rag-queries", "2", "--offered-qps", "300", "--new-tokens", "2"])
    assert "finished 2/2 requests" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "no-such-arch", "--device", "cpu"])
    assert "unknown arch 'no-such-arch'; choose from" in capsys.readouterr().err
    with pytest.raises(ValueError, match="model"):
        tserve.serve_rag_open_loop_generate(
            pipe=tserve.build_rag_pipeline(n_docs=8, n_shards=1, dim=32, device="cpu"))
