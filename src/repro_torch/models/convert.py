"""Weights across: the JAX `DecoderLM.init` param tree -> the port's
`DecoderLM` state dict.

The JAX tree has layer-stacked blocks (a leading L axis on every leaf of
`params["blocks"]`), split here per layer. Both packages keep weights in
(d_in, d_out) layout, so no transpose is needed. Leaves are numpy arrays
(`jax.tree.map(np.asarray, params)`); bfloat16 leaves (the ml_dtypes
type) are carried across bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_jax(tree: dict, cfg: ModelConfig) -> dict:
    """State dict for `DecoderLM(cfg).load_state_dict(...)`."""
    blocks = tree["blocks"]
    L = cfg.n_layers
    per_layer = {
        "attn_norm": blocks["attn_norm"]["scale"],
        "wq": blocks["attn"]["wq"],
        "wk": blocks["attn"]["wk"],
        "wv": blocks["attn"]["wv"],
        "wo": blocks["attn"]["wo"],
        "mlp_norm": blocks["mlp_norm"]["scale"],
        "w_gate": blocks["mlp"]["w_gate"],
        "w_up": blocks["mlp"]["w_up"],
        "w_down": blocks["mlp"]["w_down"],
    }
    state = {
        "embed": _tensor(tree["embedding"]["embed"]),
        "final_norm": _tensor(tree["final_norm"]["scale"]),
    }
    for name, stacked in per_layer.items():
        stacked = np.asarray(stacked)
        if stacked.shape[0] != L:
            raise ValueError(f"blocks.{name} has {stacked.shape[0]} layers, "
                             f"config says {L}")
        for i in range(L):
            state[f"blocks.{i}.{name}"] = _tensor(stacked[i])
    return state
