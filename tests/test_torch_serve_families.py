"""Port vs JAX: the serving CLI's generation entry points on the ssm,
hybrid and audio architectures at smoke size, on the CPU —
`serve(arch)` (batched `GenerationEngine`, the prompt streamed through
`decode_step`), `build_rag_pipeline(arch=)` with `query_many` and a
`query_stream(generate=True, paged=True)` through the slot-resident
engine, each holding tokens (and retrieved ids) equal to the JAX
driver's with the same converted fp32 weights (`_torch_ssm`); and
`serve --arch` / `serve --rag --open-loop --generate --paged --arch`
end to end with the port's own seeded models."""
import json

import numpy as np
import pytest

from _torch_ssm import ARCHS, check_serve, converted_pipelines
from repro.serving import EngineConfig as JaxEngineConfig
from repro_torch.launch import serve as tserve
from repro_torch.serving import EngineConfig

SIZE = dict(n_docs=24, n_shards=2, dim=32, max_prompt_len=40)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_jax(arch, monkeypatch):
    check_serve(arch, monkeypatch)


def test_query_many_mamba2_matches_jax():
    jpipe, tpipe = converted_pipelines("mamba2-2.7b", **SIZE)
    queries = [tpipe.doc_texts[3], tpipe.doc_texts[11]]
    want = jpipe.query_many(queries, k=2, max_new_tokens=3)
    got = tpipe.query_many(queries, k=2, max_new_tokens=3)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.doc_ids, w.doc_ids)
        np.testing.assert_array_equal(g.answer_tokens, w.answer_tokens)
    assert [int(g.doc_ids[0]) for g in got] == [3, 11]


def test_query_stream_zamba2_matches_jax():
    """`build_rag_pipeline(arch="zamba2-2.7b").query_stream(generate=True,
    paged=True)`: the slot-resident engine (no pool, no prefix sharing)
    yields, per query, the JAX stream's doc ids and tokens."""
    jpipe, tpipe = converted_pipelines("zamba2-2.7b", **SIZE)
    queries = [tpipe.doc_texts[i] for i in (2, 7, 13)]
    knobs = dict(n_slots=2, paged=True, prefill_chunk=8)

    def by_query(items):
        assert all(it._error is None for it in items)
        return {it.text: (np.asarray(it.retrieval.doc_ids).tolist(), list(it.tokens))
                for it in items}

    want = by_query(list(jpipe.query_stream(queries, k=2, generate=True, max_new_tokens=3,
                                            config=JaxEngineConfig(**knobs))))
    engines = []
    make = tpipe.decode_engine
    tpipe.decode_engine = lambda *a, **kw: engines.append(make(*a, **kw)) or engines[-1]
    got = by_query(list(tpipe.query_stream(queries, k=2, generate=True, max_new_tokens=3,
                                           config=EngineConfig(**knobs))))
    assert got == want and len(got) == 3
    eng = engines[0]
    assert eng.paged and eng._pcm is None and eng.prefix_sharing is False
    assert "pool" not in eng.stats() and eng.stats()["n_finished"] == 3


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_generation_modes(arch, tmp_path, capsys):
    tserve.main(["--arch", arch, "--device", "cpu", "--batch", "2", "--prompt-len", "4",
                 "--new-tokens", "2"])
    assert "generated (2, 2) tokens" in capsys.readouterr().out
    report = tmp_path / "report.json"
    tserve.main(["--rag", "--open-loop", "--generate", "--arch", arch, "--device", "cpu",
                 "--rag-docs", "16", "--n-shards", "2", "--batch", "4", "--rag-queries",
                 "4", "--offered-qps", "300", "--new-tokens", "2", "--paged", "--n-slots",
                 "2", "--prefill-chunk", "16", "--json", str(report)])
    assert "finished 4/4 requests" in capsys.readouterr().out
    rep = json.loads(report.read_text())
    assert rep["n_failed"] == 0 and rep["paged"] and not rep["prefix_sharing"]
    assert "pool" not in rep and rep["n_prefill_chunks"] >= 4
