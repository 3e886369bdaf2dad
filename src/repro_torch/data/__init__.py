"""repro_torch.data — the byte tokenizer."""
from .tokenizer import BOS, EOS, PAD, SEP, VOCAB_SIZE, ByteTokenizer  # noqa: F401
