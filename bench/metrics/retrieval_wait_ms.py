"""Median `AsyncTicket.wait_s` (submit -> served by a flush of the
retrieval scheduler) of the requests due in the window, in ms."""
from bench import readers


def read(run):
    return readers.retrieval_wait_ms(run)
