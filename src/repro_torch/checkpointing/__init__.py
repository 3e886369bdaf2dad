"""repro_torch.checkpointing — atomic, rotating checkpoints that restore
on any device (counterpart of `repro.checkpointing`)."""
from .checkpoint import restore, save  # noqa: F401
from .manager import CheckpointManager, StepWatchdog  # noqa: F401
