"""Batched synchronous generation — counterpart of
`repro.serving.engine.GenerationEngine`.

Greedy decoding by default; `temperature > 0` samples from
softmax(logits / T) with a `torch.Generator` (the draws are not the JAX
package's). The whole batch enters and leaves together. Rows that emit
`eos_id` are frozen to `eos_id` for the rest of the batch.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


class GenerationEngine:
    def __init__(self, model, temperature: float = 0.0, device: DeviceLike = None):
        """`model` is a `DecoderLM` whose weights live on `device`
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
        logits, caches = self.model.prefill(prompts, cache_len=cache_len)

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
