"""Error-aware bit-wise remapping (paper §III-C).

Physical layout: one DIRC cell = an 8x8 MLC subarray = 64 cells, each
storing (MSB, LSB). It holds 128 bits = sixteen INT8 values ("slots").
Each slot therefore owns 4 cells = 4 MSB-bit positions + 4 LSB-bit
positions. A *mapping* assigns each (slot, bit-index) to a cell position
(row, col) and a level (0=MSB, 1=LSB).

Strategies (increasing error-awareness):
  * interleaved ("naive"): consecutive bits packed per cell —
    bit 2j -> cell_j.MSB, bit 2j+1 -> cell_j.LSB. Bit 7 (sign!) lands on an
    LSB, so sensing errors can flip signs: the worst case the paper argues
    against.
  * grouped: high half of the bits (4-7 for INT8, incl. sign) -> MSB
    positions (error-free), low half -> LSB positions in fixed row-major
    order. Error magnitude bounded to |Δ| <= 15 per element.
  * error_aware: grouped + the LSB positions of each slot sorted by the
    spatial error map — the highest remaining bit (bit 3) goes to the most
    reliable position, bit 0 to the least reliable (paper: +24.6%
    retrieval precision, Fig. 6).

The mapping is represented as int array (n_slots, bits, 3): (row, col, lvl).
"""
from __future__ import annotations

import numpy as np

from .error_model import (
    CELLS,
    SUBARRAY_COLS,
    SUBARRAY_ROWS,
    ErrorModelConfig,
    lsb_error_map,
)

STRATEGIES = ("interleaved", "grouped", "error_aware")


def _slot_cells(bits: int) -> tuple[int, int]:
    """(#slots, #cells per slot) for a given precision.

    INT8: 16 slots x 4 cells; INT4: 32 slots x 2 cells (paper: a column
    stores twice as many INT4 embeddings).
    """
    cells_per_slot = bits // 2  # each MLC cell contributes 2 bits
    n_slots = CELLS // cells_per_slot
    return n_slots, cells_per_slot


def _cell_rc(flat: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return flat // SUBARRAY_COLS, flat % SUBARRAY_COLS


def build_mapping(
    strategy: str,
    bits: int = 8,
    error_cfg: ErrorModelConfig | None = None,
) -> np.ndarray:
    """Return (n_slots, bits, 3) int array of (row, col, level).

    For error_aware, the spatial map is derived from `error_cfg` (the
    offline Fig. 5a extraction). To remap against a map learned online —
    arbitrary data, not a config — use `build_mapping_for_map`.
    """
    if strategy == "error_aware":
        cfg = error_cfg or ErrorModelConfig()
        return build_mapping_for_map(strategy, bits, lsb_error_map(cfg))
    return build_mapping_for_map(strategy, bits, None)


def build_mapping_for_map(
    strategy: str,
    bits: int = 8,
    lsb_map: np.ndarray | None = None,
) -> np.ndarray:
    """`build_mapping` against an explicit (8, 8) LSB error map.

    This is the entry point the recalibration loop uses: the map is
    whatever the detection statistics currently say, not necessarily any
    `ErrorModelConfig`'s profile. `lsb_map` is ignored for the
    map-oblivious strategies (interleaved / grouped) and required for
    error_aware.
    """
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy must be in {STRATEGIES}, got {strategy!r}")
    n_slots, cps = _slot_cells(bits)
    mapping = np.zeros((n_slots, bits, 3), dtype=np.int64)
    # Row-major partition of the 64 cells into slots.
    all_cells = np.arange(CELLS, dtype=np.int64).reshape(n_slots, cps)

    if strategy == "interleaved":
        for s in range(n_slots):
            cells = all_cells[s]
            for j in range(cps):
                r, c = _cell_rc(cells[j : j + 1])
                mapping[s, 2 * j] = (r[0], c[0], 0)      # even bit -> MSB
                mapping[s, 2 * j + 1] = (r[0], c[0], 1)  # odd bit -> LSB
        return mapping

    half = bits // 2
    if strategy == "grouped":
        for s in range(n_slots):
            cells = all_cells[s]
            r, c = _cell_rc(cells)
            for j in range(half):
                mapping[s, half + j] = (r[j], c[j], 0)  # bits half..bits-1 -> MSB
                mapping[s, j] = (r[j], c[j], 1)         # bits 0..half-1 -> LSB
        return mapping

    # error_aware: sort each slot's cells by LSB error rate ascending;
    # highest remaining LSB-group bit -> most reliable position.
    if lsb_map is None:
        raise ValueError("error_aware remapping requires an lsb_map")
    emap = np.asarray(lsb_map, dtype=np.float64)
    if emap.shape != (SUBARRAY_ROWS, SUBARRAY_COLS):
        raise ValueError(
            f"lsb_map must be {(SUBARRAY_ROWS, SUBARRAY_COLS)}, got {emap.shape}")
    for s in range(n_slots):
        cells = all_cells[s]
        r, c = _cell_rc(cells)
        order = np.argsort(emap[r, c], kind="stable")  # ascending error
        r_sorted, c_sorted = r[order], c[order]
        for j in range(half):
            # bit (half-1) -> order 0 (best), ..., bit 0 -> order half-1 (worst)
            b = half - 1 - j
            mapping[s, b] = (r_sorted[j], c_sorted[j], 1)
            # MSB assignment order is irrelevant (p=0); keep aligned layout.
            mapping[s, half + b] = (r_sorted[j], c_sorted[j], 0)
    return mapping


def validate_mapping(mapping: np.ndarray, bits: int) -> None:
    """Invariants: each slot uses `bits//2` distinct cells, each exactly
    once per level; positions in range. Raises AssertionError otherwise."""
    n_slots, nbits, three = mapping.shape
    assert nbits == bits and three == 3
    assert (mapping[..., 0] >= 0).all() and (mapping[..., 0] < SUBARRAY_ROWS).all()
    assert (mapping[..., 1] >= 0).all() and (mapping[..., 1] < SUBARRAY_COLS).all()
    assert set(np.unique(mapping[..., 2])) <= {0, 1}
    used = set()
    for s in range(n_slots):
        for b in range(bits):
            r, c, l = mapping[s, b]
            key = (int(r), int(c), int(l))
            assert key not in used, f"position {key} double-booked"
            used.add(key)
    assert len(used) == n_slots * bits
