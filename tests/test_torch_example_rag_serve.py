"""`examples_torch/rag_serve.py` against `examples/rag_serve.py`, the
twin serving the reference's own weights (`model.init(jax.random.key(0))`
carried across by `repro_torch.models.convert`).

Both examples run phi4-mini's smoke model in fp32 here (the reference's
`get_config` is patched in its module; ROADMAP T25: bf16 rounds the two
packages' logits apart). A recording subclass of the reference's
`RagPipeline` keeps its `query_many` results and its generation tickets.
The shard loads, retrieved ids (scores allclose at fp32), the added and
tombstoned ids, the schedulers' ids, the async and stream ids as sets per
query, `query_many`'s answer tokens, the streamed generations' tokens and
`token_stream`'s tokens are equal. Timings and completion order are not
compared."""
import ast
import dataclasses
import re

import numpy as np
import pytest

from _torch_examples import one_thread, printed, reference, twin
from _torch_parity import converted_models
from repro.configs import get_config as jax_get_config


@pytest.fixture(scope="module")
def runs():
    ref = reference("rag_serve")
    rec = {"generate": {}}

    class Recording(ref.RagPipeline):
        def query_many(self, *args, **kwargs):
            out = super().query_many(*args, **kwargs)
            rec.setdefault("wave", out)        # the batched wave: the first call
            return out

        def query_stream(self, *args, **kwargs):
            for t in super().query_stream(*args, **kwargs):
                if kwargs.get("generate"):
                    rec["generate"][t.text] = {
                        "doc_ids": np.asarray(t.retrieval.doc_ids).tolist(),
                        "tokens": [int(x) for x in t.tokens]}
                yield t

    ref.RagPipeline = Recording
    ref.get_config = lambda arch, smoke=False: dataclasses.replace(
        jax_get_config(arch, smoke), compute_dtype="float32")
    _, lines = printed(ref.main)
    _, _, tmodel = converted_models(seed=0)
    with one_thread():
        out, tlines = printed(twin("rag_serve").main, ["--device", "cpu"], model=tmodel)
    return {"lines": lines, "rec": rec, "out": out, "tlines": tlines}


def _section(lines, title: str) -> list:
    """The lines after the `== title` header, up to the next blank line."""
    i = next(n for n, line in enumerate(lines) if line.startswith(f"== {title}"))
    rest = lines[i + 1:]
    return rest[:rest.index("")] if "" in rest else rest


def test_shard_loads_identical(runs):
    want = [line for line in runs["lines"] if line.startswith("   shard loads:")]
    assert len(want) == 1
    assert want == [line for line in runs["tlines"] if line.startswith("   shard loads:")]
    assert f"   shard loads: {np.asarray(runs['out']['shard_loads'])}" == want[0]


def test_retrieved_ids_and_scores(runs):
    wave = runs["rec"]["wave"]
    assert len(wave) == len(runs["out"]["wave"]) == 3
    for want, got in zip(wave, runs["out"]["wave"]):
        assert np.asarray(want.doc_ids).tolist() == got["doc_ids"]
        np.testing.assert_allclose(got["scores"], np.asarray(want.doc_scores),
                                   rtol=1e-5, atol=1e-6)
    pick = [line for line in runs["lines"] if line.startswith(("Q: ", "   retrieved["))]
    assert len(pick) == 9
    assert pick == [line for line in runs["tlines"] if line.startswith(("Q: ", "   retrieved["))]


def test_query_many_answer_tokens_identical(runs):
    for want, got in zip(runs["rec"]["wave"], runs["out"]["wave"]):
        assert np.asarray(want.answer_tokens)[0].tolist() == got["answer_tokens"]
        assert len(got["answer_tokens"]) == 12


def test_added_and_tombstoned_ids_identical(runs):
    title = "live corpus update"
    want = _section(runs["lines"], title)
    assert want == _section(runs["tlines"], title)
    upd = runs["out"]["update"]
    assert upd["added_id"] == upd["retrieved_id"] == 64
    assert upd["after_delete_id"] != 64
    assert f"after delete, retrieved id {upd['after_delete_id']} " in want[1]


def test_pull_scheduler_ids_identical(runs):
    want = _section(runs["lines"], "micro-batching scheduler")
    got = runs["out"]["pull"]
    rows = [re.match(r"   \[ *(\d+)\] score ([+-]\d\.\d+)  <- ", line) for line in want[1:-1]]
    assert [int(m.group(1)) for m in rows] == got["ids"]
    np.testing.assert_allclose(got["scores"], [float(m.group(2)) for m in rows], atol=5e-4)
    assert want[0] == "   queued 3 queries" and want[-1] == _section(
        runs["tlines"], "micro-batching scheduler")[-1]


def test_async_and_stream_ids_identical_per_query(runs):
    twin_mod = twin("rag_serve")
    want = _section(runs["lines"], "async scheduler")
    rows = [re.match(r"   tenant (\w+): \[ *(\d+)\] after ", line) for line in want]
    assert len(rows) == 3
    for q, m in zip(twin_mod.QUERIES, rows):     # the reference prints in submit order
        got = runs["out"]["async"][q]
        assert {(m.group(1), int(m.group(2)))} == {(got["tenant"], got["doc_ids"][0])}
    want = _section(runs["lines"], "query_stream")
    pairs = {(int(m.group(1)), m.group(2)) for m in
             (re.match(r"   alice: \[ *(\d+)\] <- (.*)$", line) for line in want)}
    assert pairs == {(ids[0], q[:50]) for q, ids in runs["out"]["stream"].items()}


def test_streamed_generations_identical_per_query(runs):
    want, got = runs["rec"]["generate"], runs["out"]["generate"]
    assert set(want) == set(got) and len(got) == 3
    for q in want:
        assert want[q] == got[q], q
    assert all(len(g["tokens"]) == 8 for g in got.values())


def test_token_stream_identical(runs):
    line = _section(runs["lines"], "token_stream")[0]
    want = ast.literal_eval(line.split("one at a time: ")[1])
    assert want == runs["out"]["token_stream"]
    assert line == _section(runs["tlines"], "token_stream")[0]
