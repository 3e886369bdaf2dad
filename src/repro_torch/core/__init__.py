"""repro_torch.core — the DIRC retrieval engine in PyTorch: quantization,
the two's-complement bit-plane image, the sensing-error channel with
Sigma-D detection and error-aware remapping, hierarchical top-k, the
sharded multi-macro index with per-macro device physics and online
recalibration, and the analytic cycle/energy model (`simulator`,
`dataflow`)."""
from . import (  # noqa: F401
    bitplane,
    dataflow,
    device_physics,
    error_detection,
    error_model,
    quantization,
    recalibration,
    remapping,
    retrieval,
    sharded_index,
    simulator,
    topk,
)
from .device_physics import DevicePhysics, DriftConfig  # noqa: F401
from .error_model import ErrorModelConfig  # noqa: F401
from .quantization import QuantizedTensor, quantize, quantize_query  # noqa: F401
from .retrieval import PATHS, DircRagIndex, RetrievalConfig  # noqa: F401
from .topk import TopK, hierarchical_topk, local_topk  # noqa: F401
from .recalibration import RecalibrationConfig, RecalibrationController  # noqa: F401
from .sharded_index import ShardedDircIndex  # noqa: F401
