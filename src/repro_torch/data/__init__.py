"""repro_torch.data — the byte tokenizer, the synthetic corpora and the
resumable training data pipeline (numpy copies of `repro.data`)."""
from .pipeline import DataPipeline, PipelineState  # noqa: F401
from .synthetic import BigramLM, IRDataset, beir_analogue, make_ir_dataset  # noqa: F401
from .tokenizer import BOS, EOS, PAD, SEP, VOCAB_SIZE, ByteTokenizer  # noqa: F401
