"""The traffic generator: the same seed gives the same traffic; every
seed gives the same sizes in another order, and the same arrivals."""
import numpy as np
import pytest

from bench import traffic
from bench.tests._smoke import TINY

DOCQA = {"k": 8, "query_tokens": [32, 96], "answer_tokens": [16, 64], "block": 64}


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3])
def test_same_seed_same_traffic(seed):
    a_docs, b_docs = traffic.documents(32, 128, seed), traffic.documents(32, 128, seed)
    assert np.array_equal(a_docs, b_docs)
    a = traffic.requests(DOCQA, a_docs, seed, 150)
    b = traffic.requests(DOCQA, b_docs, seed, 150)
    assert a == b


def test_seeds_share_sizes_not_order():
    docs1, docs2 = traffic.documents(32, 128, 1), traffic.documents(32, 128, 2)
    assert not np.array_equal(docs1, docs2)
    r1 = traffic.requests(DOCQA, docs1, 1, 128)
    r2 = traffic.requests(DOCQA, docs2, 2, 128)
    assert [r.max_new_tokens for r in r1] != [r.max_new_tokens for r in r2]
    assert sorted(r.max_new_tokens for r in r1) == sorted(r.max_new_tokens for r in r2)
    assert sorted(len(r.query) for r in r1) == sorted(len(r.query) for r in r2)


def test_arrivals_are_poisson_gaps_the_same_for_every_seed():
    due = traffic.arrivals(2.0, 129, 64)
    assert due[0] == 0.0 and np.array_equal(due, traffic.arrivals(2.0, 129, 64))
    g1, g2 = np.diff(due)[:64], np.diff(due)[64:128]
    assert not np.allclose(g1, g2)            # each block in another order
    assert np.allclose(np.sort(g1), np.sort(g2))
    assert np.isclose(g1.sum(), 64 / 2.0)     # a block's mean gap is 1 / rate
    # exponential gaps: bursts of short gaps, a few long ones
    assert g1.min() < 0.02 / 2.0 and g1.max() > 4 / 2.0
    assert np.isclose(np.median(g1), np.log(2) / 2.0, rtol=0.05)


def test_queries_are_spans_of_their_documents():
    docs = traffic.documents(16, 64, 3)
    texts = traffic.texts(docs)
    for r in traffic.requests(TINY, docs, 3, 40):
        assert r.query in texts[r.doc]
        assert TINY["query_tokens"][0] <= len(r.query) <= TINY["query_tokens"][1]
        assert TINY["answer_tokens"][0] <= r.max_new_tokens <= TINY["answer_tokens"][1]


def test_prompt_length_is_the_tokenizers():
    from repro_torch.data.tokenizer import ByteTokenizer

    docs = traffic.texts(traffic.documents(8, 128, 4))
    ids = ByteTokenizer().encode_rag_prompt("q" * 96, docs, 10**6)
    assert len(ids) == traffic.max_prompt_tokens(DOCQA, 128) == 1 + 8 * 129 + 96
