"""repro_torch.optim — AdamW with an fp32 master copy, the 8-bit-moment
AdamW, and INT8 gradient compression (counterpart of `repro.optim`)."""
from . import adamw, grad_compression, quant_state  # noqa: F401
from .adamw import AdamWConfig, AdamWState  # noqa: F401
