"""The one traffic generator: documents, requests and arrival times from
a mix's parameters and the seed.

Lengths are tokens of the port's byte tokenizer (one byte, one token).
A document is `doc_tokens` random lowercase letters and spaces. A query
is a span of `query_tokens` cut from a document drawn uniformly, so it
has a right answer in the index. Each request asks for its own
`max_new_tokens` from `answer_tokens`.

Every seed sees the same sizes in another order: query and answer
lengths are the evenly spaced quantiles of their ranges, shuffled within
each block of `block` requests. So the seed moves which document is
asked about and the order of the work, not its amount. The open loop's
arrivals are bursty, with the gaps of a Poisson process, and the same
for every seed.
"""
from __future__ import annotations

import dataclasses
import numpy as np

# 0-25 are the letters, 26-31 a space: about one byte in five is a space
_ALPHABET = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz      ", np.uint8)


def rng(seed: int, stream: int) -> np.random.Generator:
    """A generator for one stream of one seed (any whole number)."""
    return np.random.default_rng([int(seed) % 2**64, stream])


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    doc: int              # the document the query was cut from
    query: str
    k: int
    max_new_tokens: int


def documents(n_docs: int, doc_tokens: int, seed: int) -> np.ndarray:
    """(n_docs, doc_tokens) uint8 ASCII bytes of the corpus."""
    codes = rng(seed, 0).integers(0, len(_ALPHABET), size=(n_docs, doc_tokens))
    return _ALPHABET[codes]


def texts(doc_bytes: np.ndarray) -> list[str]:
    return [row.tobytes().decode("ascii") for row in doc_bytes]


def _strata(lo: int, hi: int, n: int, block: int, g: np.random.Generator) -> np.ndarray:
    """n whole numbers in [lo, hi]: each block holds the evenly spaced
    quantiles of the range, shuffled."""
    j = np.arange(block)
    one = lo + np.floor((j + 0.5) * (hi - lo + 1) / block).astype(np.int64)
    return np.concatenate([g.permutation(one) for _ in range(-(-n // block))])[:n]


def requests(mix: dict, doc_bytes: np.ndarray, seed: int, n: int) -> list[Request]:
    """The first n requests of the seed's sequence."""
    g = rng(seed, 1)
    n_docs, doc_tokens = doc_bytes.shape
    block = int(mix["block"])
    qlen = _strata(*mix["query_tokens"], n, block, g)
    alen = _strata(*mix["answer_tokens"], n, block, g)
    docs = g.integers(0, n_docs, size=n)
    offs = g.integers(0, doc_tokens - qlen + 1)
    return [Request(index=i, doc=int(d),
                    query=doc_bytes[d, o:o + q].tobytes().decode("ascii"),
                    k=int(mix["k"]), max_new_tokens=int(a))
            for i, (d, o, q, a) in enumerate(zip(docs, offs, qlen, alen))]


ARRIVAL_STREAM = 2   # the arrivals' shuffle: a fixed stream, not the seed's


def arrivals(rate: float, n: int, block: int) -> np.ndarray:
    """Due times (s after the window opens) of n open-loop arrivals at
    `rate` per second: exponential gaps, each block of them the evenly
    spaced quantiles of the distribution scaled to a mean of exactly
    1 / rate, shuffled by a fixed stream. The bursts are a Poisson
    process's, and every seed meets the same ones."""
    g = rng(0, ARRIVAL_STREAM)
    u = (np.arange(block) + 0.5) / block
    one = -np.log1p(-u)
    one = one / one.mean() / rate
    gaps = np.concatenate([g.permutation(one) for _ in range(-(-n // block))])[:n]
    return np.concatenate([[0.0], np.cumsum(gaps[:-1])])


def max_prompt_tokens(mix: dict, doc_tokens: int) -> int:
    """The longest augmented prompt: [BOS] (doc [SEP]) x k, query."""
    return 1 + int(mix["k"]) * (doc_tokens + 1) + int(mix["query_tokens"][1])
