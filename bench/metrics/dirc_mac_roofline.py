"""K1 (`dirc_mac_packed`, the bit-serial MAC of every search) in the
profiled slice: the least time its recorded calls need (the larger of
their int8 operations over the int8 peak and their bytes over the HBM
rate) over its device time, in %."""
from bench import readers


def read(run):
    return readers.roofline_pct(run, "k1")
