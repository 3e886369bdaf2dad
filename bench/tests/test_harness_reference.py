"""The plain reference against the port at toy sizes on the CPU: the
model's logits, the retrieval, the embeddings and the prompt."""
import numpy as np
import pytest
import torch

from bench import embed, traffic, weights
from bench.reference import lm, prompt, retrieval
from bench.tests import _smoke

CPU = torch.device("cpu")


def _port(cfg):
    from bench.harness import model_config
    from repro_torch.models import build_model

    model = build_model(model_config(cfg), device=CPU)
    weights.fill_model(model, cfg, seed=5)
    return model


@pytest.mark.parametrize("cfg", [_smoke.DENSE,
                                 dict(_smoke.MOE, moe={"n_experts": 4, "top_k": 2,
                                                       "capacity_factor": 2.0})],
                         ids=["dense", "moe"])
def test_logits_match_the_port(cfg):
    model = _port(cfg)
    toks = traffic.rng(5, 9).integers(0, cfg["vocab_size"], size=40).tolist()
    with torch.no_grad():
        port = model(torch.as_tensor([toks]))[0][0, :, :cfg["vocab_size"]]
    ref = lm.logits_at(cfg, lambda g: weights.make(cfg, 5, g, CPU), [toks],
                       [list(range(len(toks)))], CPU)[0]
    assert torch.allclose(port, ref, atol=2e-4, rtol=1e-4)
    # the fp8 control is a different model
    low = lm.logits_at(cfg, lambda g: weights.make(cfg, 5, g, CPU), [toks],
                       [list(range(len(toks)))], CPU, precision="fp8")[0]
    assert (low - ref).abs().max() > 1e-2


def test_weights_are_made_again_bit_for_bit():
    cfg = _smoke.MOE
    model = _port(cfg)
    params = dict(model.named_parameters())
    for g, plan in enumerate(weights.groups(cfg)):
        again = weights.make(cfg, 5, g, CPU)
        for name, _, _ in plan:
            assert torch.equal(params[name].data, again[name])


def test_retrieval_matches_the_port():
    from bench.harness import retrieval_config
    from repro_torch.core.sharded_index import ShardedDircIndex
    from repro_torch.serving import HashEmbedder

    index = _smoke.DENSE["index"]
    docs = traffic.documents(index["n_docs"], index["doc_tokens"], 3)
    embs = embed.embed_corpus(docs, index["dim"], CPU)
    port_embs = HashEmbedder(dim=index["dim"]).embed(traffic.texts(docs))
    assert np.allclose(embs, port_embs, atol=1e-6)
    reqs = traffic.requests(_smoke.TINY, docs, 3, 12)
    queries = [r.query for r in reqs]
    idx = ShardedDircIndex.build(embs, retrieval_config(index), n_shards=4, device=CPU)
    port_q = HashEmbedder(dim=index["dim"]).embed(queries)
    res = idx.search(port_q, k=3)
    proj = embed.projection(index["dim"])
    q = np.stack([embed.embed_text(t, proj) for t in queries])
    assert np.array_equal(q, port_q)
    dc = retrieval.quantize(embs)
    ids, vals = retrieval.top_k(retrieval.cosine_scores(retrieval.quantize(q), dc,
                                                        retrieval.int_norms(dc)), 3)
    assert np.array_equal(ids, res.indices.numpy())
    assert np.array_equal(vals, res.scores.numpy())
    # most queries find the document they were cut from
    assert sum(ids[i, 0] == r.doc for i, r in enumerate(reqs)) >= 0.75 * len(reqs)


def test_prompt_matches_the_tokenizer():
    from repro_torch.data.tokenizer import ByteTokenizer

    docs = traffic.texts(traffic.documents(3, 20, 1))
    for max_len in (10**6, 30):
        want = [t % 300 for t in ByteTokenizer().encode_rag_prompt("a query", docs, max_len)]
        assert prompt.rag_prompt("a query", docs, max_len, 300) == want


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _smoke.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ["toy.open", "toy.closed"])
def test_a_sound_run_is_correct(root, cell):
    out = _smoke.run(root, cell)
    assert out["correct"], out["checks"]
    assert out["checks"]["search_gap"]["value"] == 0.0
    assert out["checks"]["logit_gap"]["value"] == 0.0    # fp32 toy: every token agrees
    assert list(out)[-1] == "checks"
