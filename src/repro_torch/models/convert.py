"""Weights across: the JAX `DecoderLM.init` param tree -> the port's
`DecoderLM` state dict.

The JAX tree has layer-stacked blocks (a leading L axis on every leaf of
`params["blocks"]`), split here per layer. Both packages keep weights in
(d_in, d_out) layout (experts (E, d_in, d_out)), so no transpose is
needed. Leaves are numpy arrays (`jax.tree.map(np.asarray, params)`);
bfloat16 leaves (the ml_dtypes type) are carried across bit for bit.

Where each JAX leaf goes:
  embedding.embed / .lm_head        -> embed / lm_head
  final_norm.scale                  -> final_norm
  blocks.{attn_norm,mlp_norm}.scale -> blocks.i.{attn_norm,mlp_norm}
  blocks.attn.{wq,wk,wv,wo,bq,bk,bv} -> blocks.i.<name>
  blocks.mlp.<name>                 -> blocks.i.mlp.<name>
  blocks.moe.<name>                 -> blocks.i.moe.<name> (router, the
                                       experts, dense_residual.*)
A leaf that has no place in the port's model, a place the tree leaves
empty, or a shape that differs raises ValueError.
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


def _leaves(tree: dict, prefix: str = ""):
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _leaves(val, path + ".")
        else:
            yield path, val


def _block_name(path: str) -> str:
    """A `blocks.` leaf's name inside the port's `Block`: norm scales and
    attention weights sit on the block, `mlp.*` and `moe.*` keep their
    nesting."""
    if path.endswith("norm.scale"):
        return path[: -len(".scale")]
    if path.startswith("attn."):
        return path[len("attn."):]
    return path


def params_from_jax(tree: dict, cfg: ModelConfig) -> dict:
    """State dict for `DecoderLM(cfg).load_state_dict(...)`."""
    from .transformer import DecoderLM

    want = {k: tuple(v.shape) for k, v in DecoderLM(cfg, device="meta").state_dict().items()}
    L = cfg.n_layers
    state = {}
    for path, leaf in _leaves(tree):
        group, _, rest = path.partition(".")
        if group == "blocks":
            stacked = np.asarray(leaf)
            if stacked.shape[0] != L:
                raise ValueError(f"{path} has {stacked.shape[0]} layers, config says {L}")
            name = _block_name(rest)
            for i in range(L):
                state[f"blocks.{i}.{name}"] = _tensor(stacked[i])
        elif path in ("embedding.embed", "embedding.lm_head"):
            state[rest] = _tensor(leaf)
        elif path == "final_norm.scale":
            state["final_norm"] = _tensor(leaf)
        else:
            raise ValueError(f"JAX leaf {path} has no place in the port's DecoderLM")
    extra = sorted(set(state) - set(want))
    missing = sorted(set(want) - set(state))
    if extra or missing:
        raise ValueError(f"{cfg.name}: JAX leaves without a place {extra[:4]}, port "
                         f"weights the tree leaves empty {missing[:4]}")
    for k, t in state.items():
        if tuple(t.shape) != want[k]:
            raise ValueError(f"{k}: JAX shape {tuple(t.shape)}, port {want[k]}")
    return state
