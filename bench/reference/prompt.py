"""The augmented prompt, in the byte tokenizer's ids: [BOS], each
retrieved document's bytes followed by [SEP], then the query's bytes;
the last `max_len` ids are kept."""
from __future__ import annotations

from typing import Sequence

BOS, SEP = 257, 259


def rag_prompt(query: str, docs: Sequence[str], max_len: int, vocab: int) -> list[int]:
    ids = [BOS]
    for d in docs:
        ids += list(d.encode("utf-8", errors="replace")) + [SEP]
    ids += list(query.encode("utf-8", errors="replace"))
    return [t % vocab for t in ids[-max_len:]]
