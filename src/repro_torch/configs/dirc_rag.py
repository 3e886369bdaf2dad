"""The paper's own configuration: DIRC-RAG retrieval at the published
operating point — 4 MB INT8 database, dim 512 (all-MiniLM-L6-v2 x2),
16 cores, cosine similarity, error-aware mapping + detection enabled.
"""
from repro_torch.core.error_model import ErrorModelConfig
from repro_torch.core.retrieval import RetrievalConfig

PAPER_DB_MB = 4.0
PAPER_DIM = 512
PAPER_FREQ_HZ = 250e6

RETRIEVAL_INT8 = RetrievalConfig(
    bits=8, metric="cosine", n_cores=16, path="int_exact",
    mapping="error_aware",
    error=ErrorModelConfig(enabled=False),
    detect=True,
)

RETRIEVAL_INT4 = RetrievalConfig(
    bits=4, metric="cosine", n_cores=16, path="int_exact",
    mapping="error_aware",
    error=ErrorModelConfig(enabled=False),
    detect=True,
)

NOISY_INT8 = RetrievalConfig(
    bits=8, metric="cosine", n_cores=16, path="bitserial",
    mapping="error_aware",
    error=ErrorModelConfig(enabled=True, p_min=1e-3, p_max=5e-2),
    detect=True, max_retries=3,
)
