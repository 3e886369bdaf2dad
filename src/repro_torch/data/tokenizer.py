"""Self-contained byte-level tokenizer (no external vocab files)."""
from __future__ import annotations

PAD, BOS, EOS, SEP = 256, 257, 258, 259
VOCAB_SIZE = 260


class ByteTokenizer:
    vocab_size = VOCAB_SIZE
    pad_id, bos_id, eos_id, sep_id = PAD, BOS, EOS, SEP

    def encode(self, text: str, bos: bool = True, eos: bool = False) -> list:
        ids = list(text.encode("utf-8", errors="replace"))
        if bos:
            ids = [BOS] + ids
        if eos:
            ids = ids + [EOS]
        return ids

    def decode(self, ids) -> str:
        data = bytes(i for i in ids if 0 <= int(i) < 256)
        return data.decode("utf-8", errors="replace")

    def encode_rag_prompt(self, query: str, docs: list, max_len: int) -> list:
        """[BOS] doc1 [SEP] doc2 ... [SEP] query — the augmented prompt."""
        ids = [BOS]
        for d in docs:
            ids += self.encode(d, bos=False) + [SEP]
        ids += self.encode(query, bos=False)
        return ids[-max_len:]
