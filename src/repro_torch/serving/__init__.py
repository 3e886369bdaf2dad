"""repro_torch.serving — the synchronous RAG query path: `RagPipeline`
(embed -> DIRC retrieve -> augment -> generate) over `GenerationEngine`."""
from .engine import GenerationEngine  # noqa: F401
from .rag_pipeline import HashEmbedder, RagPipeline, RagResult  # noqa: F401
