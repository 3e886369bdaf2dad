"""K3 (`paged_attend_fused`: the attention and combine kernels) in the
profiled slice: the least time its recorded calls need (the larger of
their FLOPs over the bf16 peak and their bytes over the HBM rate) over
its device time, in %."""
from bench import readers


def read(run):
    return readers.roofline_pct(run, "k3")
