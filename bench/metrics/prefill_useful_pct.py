"""Valid prompt tokens over the tokens the prefill pieces computed:
the engine's `n_prefill_chunks` over the window times `prefill_chunk`
(every piece runs at full width), in %."""
from bench import readers


def read(run):
    return readers.prefill_useful_pct(run)
