"""repro_torch.perf — roofline terms of a step on the H100 (counterpart
of `repro.perf`)."""
from . import roofline  # noqa: F401
