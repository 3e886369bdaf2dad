"""repro_torch.perf — roofline terms of a step on the H100 (counterpart
of `repro.perf`), and the port's own spans and counters (`trace`)."""
from . import roofline, trace  # noqa: F401
