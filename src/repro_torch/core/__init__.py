"""repro_torch.core — the DIRC retrieval engine in PyTorch: quantization,
the two's-complement bit-plane image, the sensing-error channel with
Sigma-D detection and error-aware remapping, hierarchical top-k, and the
analytic cycle/energy model (`simulator`, `dataflow`)."""
from .error_model import ErrorModelConfig  # noqa: F401
from .quantization import QuantizedTensor, quantize, quantize_query  # noqa: F401
from .retrieval import PATHS, DircRagIndex, RetrievalConfig  # noqa: F401
from .topk import TopK, hierarchical_topk, local_topk  # noqa: F401
