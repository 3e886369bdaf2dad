"""Share of the profiled slice with no kernel running on the card, in %."""
from bench import readers


def read(run):
    return readers.idle_pct(run, in_use=False)
