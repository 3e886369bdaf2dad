"""Launch counters of the kernel wrappers, exact across threads.

Each wrapper adds one to its module's counter (`dirc_mac.LAUNCHES`,
`score_matmul.LAUNCHES` / `COSINE_LAUNCHES`, `paged_attend.LAUNCHES` /
`COMBINE_LAUNCHES`, `topk_select.LAUNCHES`) where it launches its kernel,
and nowhere else. The serving stack launches from several threads at
once (one decode loop per `EngineRouter` replica, the retrieval
scheduler), so every increment takes `LOCK`, and `read` / `reset` take
it too.
"""
from __future__ import annotations

import threading

LOCK = threading.Lock()


def _counters() -> dict:
    """Counter name -> (module, attribute)."""
    from . import dirc_mac, paged_attend, score_matmul, topk_select

    return {
        "dirc_mac": (dirc_mac, "LAUNCHES"),
        "score_matmul_int": (score_matmul, "LAUNCHES"),
        "score_matmul_cosine": (score_matmul, "COSINE_LAUNCHES"),
        "paged_attend_fused": (paged_attend, "LAUNCHES"),
        "paged_combine": (paged_attend, "COMBINE_LAUNCHES"),
        "topk_select": (topk_select, "LAUNCHES"),
    }


def read() -> dict:
    """Every counter, read at one instant."""
    counters = _counters()
    with LOCK:
        return {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}


def reset() -> None:
    """Set every counter to 0."""
    counters = _counters()
    with LOCK:
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
