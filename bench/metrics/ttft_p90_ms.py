"""90th percentile, over every request due in the window, of due time ->
first answer token (host clock); a request that failed or did not
finish by the drain limit counts as past every limit. At 100 requests
a window, 10 lie beyond it."""
from bench import readers


def read(run):
    return readers.tail_ms(run, "first", 90)
