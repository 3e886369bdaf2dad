"""Query-stationary dataflow schedule (paper §III-B, Fig. 4).

Maps a database (n_docs, dim, bits) onto the DIRC-RAG hardware hierarchy

    architecture (16 cores) -> core (1 macro) -> macro (128 columns)
      -> column (128 DIRC cells) -> cell (8x8 MLC subarray, 128 bits)

and derives the cycle schedule of one retrieval:

    per column pass over its stored slots:
      for each doc slot (16 at INT8):
        for each doc bit-plane (8 at INT8):
          1 cycle  ReRAM -> SRAM sensing (array-wide, single cycle)
          1 cycle  error-detection (optional, all-ones adder pass)
          bits cycles  bit-serial MAC against the stationary query
    => 16 * 8 * (1 + 1 + 8) = 1280 cycles per macro pass at INT8
       (paper: "1024 cycles MAC; 128 sensing; 128 detection" ~= 1300 with
        accumulator/top-k drain overhead).

Dimension folding: embeddings with dim > 128 fold across multiple
column-segments of the same column (dim 128..1024 supported); folding
changes capacity bookkeeping, not cycles-per-stored-bit.
"""
from __future__ import annotations

import dataclasses
import math

CELL_BITS = 128          # 8x8 MLC subarray, 2 bits/cell
COLUMN_CELLS = 128       # DIRC cells per column
COLUMN_BITS = CELL_BITS * COLUMN_CELLS          # 16 Kb per column
MACRO_COLUMNS = 128
MACRO_BITS = COLUMN_BITS * MACRO_COLUMNS        # 2 Mb per macro
N_CORES = 16
TOTAL_BITS = MACRO_BITS * N_CORES               # 32 Mb = 4 MB
MIN_DIM, MAX_DIM = 128, 1024


@dataclasses.dataclass(frozen=True)
class DataflowPlan:
    n_docs: int
    dim: int
    bits: int
    folds: int                # column-segments per embedding (dim / 128)
    slots_per_column: int     # embeddings stored per column
    docs_per_macro: int
    docs_per_core: int        # == docs_per_macro (1 macro per core)
    cores_used: int
    macro_passes: int         # sequential passes if db exceeds one resident fill
    sense_cycles: int
    detect_cycles: int
    mac_cycles: int
    drain_cycles: int         # accumulator drain + local top-k overhead

    @property
    def total_cycles(self) -> int:
        return (
            self.sense_cycles + self.detect_cycles + self.mac_cycles
        ) * self.macro_passes + self.drain_cycles

    @property
    def db_bytes(self) -> int:
        return self.n_docs * self.dim * self.bits // 8

    @property
    def resident(self) -> bool:
        return self.macro_passes == 1


def plan_retrieval(
    n_docs: int,
    dim: int,
    bits: int = 8,
    detect: bool = True,
    query_bits: int | None = None,
) -> DataflowPlan:
    """Build the QS schedule for one query against the whole database."""
    if not (MIN_DIM <= dim <= MAX_DIM) or dim % MIN_DIM:
        raise ValueError(f"dim must be a multiple of 128 in [128, 1024], got {dim}")
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    qbits = bits if query_bits is None else query_bits

    folds = dim // MIN_DIM
    elem_bits = bits
    # One column stores COLUMN_BITS bits; one embedding needs dim*bits bits,
    # spread over `folds` column-segments -> slots per column:
    slots_per_column = COLUMN_BITS // (dim * elem_bits)
    docs_per_macro = slots_per_column * MACRO_COLUMNS
    docs_per_core = docs_per_macro
    capacity = docs_per_core * N_CORES
    cores_used = min(N_CORES, math.ceil(n_docs / max(docs_per_core, 1)))
    macro_passes = max(1, math.ceil(n_docs / capacity))

    # Cycle counts for ONE macro pass (all cores/columns in parallel):
    planes_per_pass = slots_per_column * elem_bits * folds  # sense events per column
    sense = planes_per_pass
    detectc = planes_per_pass if detect else 0
    mac = planes_per_pass * qbits
    drain = 20  # accumulate drain + local/global top-k pipeline flush
    return DataflowPlan(
        n_docs=n_docs,
        dim=dim,
        bits=bits,
        folds=folds,
        slots_per_column=slots_per_column,
        docs_per_macro=docs_per_macro,
        docs_per_core=docs_per_core,
        cores_used=cores_used,
        macro_passes=macro_passes,
        sense_cycles=sense,
        detect_cycles=detectc,
        mac_cycles=mac,
        drain_cycles=drain,
    )
