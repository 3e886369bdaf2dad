"""Median span of a `DecoderLM.paged_step` call with t > 1 (one prefill
piece), synchronised on the card before and after, inside the window,
in ms."""
from bench import readers


def read(run):
    return readers.step_ms(run, prefill=True)
