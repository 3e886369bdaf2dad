"""Batched synchronous generation — counterpart of
`repro.serving.engine.GenerationEngine` — and the reference's deprecated
pull-based `BatchScheduler` shim over `AsyncBatchScheduler`.

Greedy decoding by default; `temperature > 0` samples from
softmax(logits / T) with a `torch.Generator` (the draws are not the JAX
package's). The whole batch enters and leaves together. Rows that emit
`eos_id` are frozen to `eos_id` for the rest of the batch. A model
without `prefill` (the SSM, hybrid and audio families) streams the
prompt through `decode_step` from `init_caches(b, cache_len, 0)`, one
token at a time, as the JAX engine does.
"""
from __future__ import annotations

import warnings
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from .async_scheduler import AsyncBatchScheduler, BatchTicket  # noqa: F401  (re-exported)


class BatchScheduler(AsyncBatchScheduler):
    """DEPRECATED pull-based scheduler, as the reference keeps it: an
    `AsyncBatchScheduler` in manual mode (no thread, no deadline), whose
    batches form only on `flush()` or a blocking `ticket.result()`. Use
    `AsyncBatchScheduler` (or `RagPipeline.scheduler(max_wait_ms=...)`)."""

    def __init__(self, batch_search: Callable[[Sequence[str], int], tuple],
                 max_batch: int = 32):
        warnings.warn(
            "BatchScheduler is deprecated; use AsyncBatchScheduler (or "
            "RagPipeline.scheduler(max_wait_ms=...)) for streaming serving",
            DeprecationWarning, stacklevel=2)
        super().__init__(batch_search, max_batch=max_batch, max_wait_ms=None, start=False)


def stream_prompt(model, caches, toks: torch.Tensor):
    """Feed toks (b, n) through `model.decode_step` one position at a
    time; returns (logits after the last, caches). How a model without
    `prefill` takes its prompt, in both engines."""
    for t in range(toks.shape[1]):
        logits, caches = model.decode_step(caches, toks[:, t:t + 1])
    return logits, caches


class GenerationEngine:
    def __init__(self, model, temperature: float = 0.0, device: DeviceLike = None):
        """`model` is any family's LM whose weights live on `device`
        (`None` is the card)."""
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model lives on {model.device}, engine on {self.device}")
        self.model = model
        self.temperature = temperature

    def _sample(self, logits: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        if self.temperature <= 0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    def generate(
        self,
        prompts,                      # (b, s) int, right-aligned
        max_new_tokens: int,
        cache_len: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        eos_id: Optional[int] = None,
    ) -> np.ndarray:
        """(b, max_new_tokens) int32 tokens (fewer columns if every row hit
        `eos_id`)."""
        prompts = torch.as_tensor(prompts, dtype=torch.long, device=self.device)
        b, s = prompts.shape
        if cache_len is None:  # 0 is a legal (if useless) explicit value
            cache_len = s + max_new_tokens
        if hasattr(self.model, "prefill"):
            logits, caches = self.model.prefill(prompts, cache_len=cache_len)
        else:
            logits, caches = stream_prompt(
                self.model, self.model.init_caches(b, cache_len, 0), prompts)

        toks = []
        done = np.zeros((b,), bool)
        cur = self._sample(logits, generator)[:, None]
        for i in range(max_new_tokens):
            step = cur[:, 0].cpu().numpy().astype(np.int32)
            if eos_id is not None:
                step = np.where(done, eos_id, step).astype(np.int32)
                done |= step == eos_id
            toks.append(step)
            if i + 1 == max_new_tokens or (eos_id is not None and done.all()):
                break
            if eos_id is not None:
                cur = torch.as_tensor(step[:, None], dtype=torch.long,
                                      device=self.device)
            logits, caches = self.model.decode_step(caches, cur)
            cur = self._sample(logits, generator)[:, None]
        return np.stack(toks, axis=1)
