"""Useful model FLOPs of the paged steps inside the window (valid tokens
only, MoE layers at their top-k experts, attention by each token's
visible context, the head at each row's last valid position) over their
summed walls times the bf16 peak (989 TFLOP/s), in %."""
from bench import readers


def read(run):
    return readers.mfu_pct(run)
