"""Prompt tokens prefilled plus answer tokens emitted inside the window,
over the window's seconds (host clock)."""
from bench import readers


def read(run):
    return readers.tokens_per_s(run)
