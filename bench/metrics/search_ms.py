"""Median span of `RagPipeline.search_batch` (the query embedding and
the sharded index's search of one flush, up to the ids on the host)
inside the window, in ms."""
from bench import readers


def read(run):
    return readers.search_ms(run)
