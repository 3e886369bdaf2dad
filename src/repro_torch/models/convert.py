"""Weights across: a JAX model's `init` param tree -> the port's state
dict, for every family (`DecoderLM`, `MambaLM`, `HybridLM`, `EncDecLM`).

The JAX tree has layer-stacked groups (a leading L axis on every leaf of
`params["blocks"]`, and of `encoder` / `decoder` for the audio family),
split here per layer. Both packages keep weights in
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
  blocks.norm.scale                 -> blocks.i.norm (Mamba2 layers)
  blocks.mamba.<name>               -> blocks.i.mamba.<name> (its gated
                                       norm's scale: mamba.norm)
  shared.<name>                     -> shared.<name> (the hybrid's one
                                       attention + MLP block, as a layer)
  encoder.* / decoder.*             -> encoder.i.* / decoder.i.* (as a
                                       layer; decoder.cross.* nested)
  enc_pos_embed, bridge             -> the same name
  enc_final_norm.scale              -> enc_final_norm
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
    """A layer leaf's name inside the port's layer module: norm scales
    (`attn_norm.scale`, `mamba.norm.scale`, ...) drop `.scale`, attention
    weights (`attn.*`) sit on the layer itself, everything else
    (`mlp.*`, `moe.*`, `mamba.*`, `cross.*`) keeps its nesting."""
    if path.endswith("norm.scale"):
        return path[: -len(".scale")]
    if path.startswith("attn."):
        return path[len("attn."):]
    return path


def _stacks(cfg: ModelConfig) -> dict:
    """Layer-stacked groups of the JAX tree -> their layer counts."""
    if cfg.encoder is not None:
        return {"encoder": cfg.encoder.n_layers, "decoder": cfg.n_layers}
    return {"blocks": cfg.n_layers}


def params_from_jax(tree: dict, cfg: ModelConfig) -> dict:
    """State dict for `build_model(cfg).load_state_dict(...)`."""
    from .model_api import build_model

    want = {k: tuple(v.shape) for k, v in build_model(cfg, device="meta").state_dict().items()}
    stacks = _stacks(cfg)
    state = {}
    for path, leaf in _leaves(tree):
        group, _, rest = path.partition(".")
        if group in stacks:
            stacked = np.asarray(leaf)
            if stacked.shape[0] != stacks[group]:
                raise ValueError(f"{path} has {stacked.shape[0]} layers, config says "
                                 f"{stacks[group]}")
            name = _block_name(rest)
            for i in range(stacks[group]):
                state[f"{group}.{i}.{name}"] = _tensor(stacked[i])
        elif group == "shared" and rest:
            state[f"shared.{_block_name(rest)}"] = _tensor(leaf)
        elif path in ("embedding.embed", "embedding.lm_head"):
            state[rest] = _tensor(leaf)
        elif path in ("final_norm.scale", "enc_final_norm.scale"):
            state[group] = _tensor(leaf)
        elif path in ("enc_pos_embed", "bridge"):
            state[path] = _tensor(leaf)
        else:
            raise ValueError(f"JAX leaf {path} has no place in the port's model")
    extra = sorted(set(state) - set(want))
    missing = sorted(set(want) - set(state))
    if extra or missing:
        raise ValueError(f"{cfg.name}: JAX leaves without a place {extra[:4]}, port "
                         f"weights the tree leaves empty {missing[:4]}")
    for k, t in state.items():
        if tuple(t.shape) != want[k]:
            raise ValueError(f"{k}: JAX shape {tuple(t.shape)}, port {want[k]}")
    return state
