"""Share of the profiled slice with no kernel running on the card,
counting only the time in which the engine held at least one request,
in %."""
from bench import readers


def read(run):
    return readers.idle_pct(run, in_use=True)
