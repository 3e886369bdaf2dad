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

`jax_leaves(cfg)` is that map read the other way: each JAX leaf path
(`blocks/attn_norm/scale`) -> the port parameters that make it up, in
layer order, and the JAX leaf's shape. The optimizer needs it (weight
decay follows the JAX leaf's rank, and the 8-bit moment's blocks of 128
run across a stacked leaf), so do the sharding tables (a spec is the
JAX leaf's, its stacked layer dim included) and the tests that carry a
JAX gradient tree across.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


_ATTN = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")


class JaxLeaf(NamedTuple):
    names: tuple       # port parameter names, in layer order
    stacked: bool      # the JAX leaf has a leading layer axis
    shape: tuple       # the JAX leaf's shape: (layers, *port shape) if stacked

    @property
    def ndim(self) -> int:
        return len(self.shape)


def _leaves(tree: dict, prefix: str = ""):
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _leaves(val, path + "/")
        else:
            yield path, val


def _layer_path(name: str) -> str:
    """A layer parameter's JAX path inside its layer: norm scales
    (`attn_norm`, `mamba.norm`, ...) gain `/scale`, attention weights on
    the layer itself sit under `attn/`, everything else (`mlp.*`, `moe.*`,
    `mamba.*`, `cross.*`) keeps its nesting."""
    if name.endswith("norm"):
        name += ".scale"
    elif name in _ATTN:
        name = "attn." + name
    return name.replace(".", "/")


def _stacks(cfg: ModelConfig) -> dict:
    """Layer-stacked groups of the JAX tree -> their layer counts."""
    if cfg.encoder is not None:
        return {"encoder": cfg.encoder.n_layers, "decoder": cfg.n_layers}
    return {"blocks": cfg.n_layers}


def _port_shapes(cfg: ModelConfig) -> dict:
    from .model_api import build_model

    return {k: tuple(v.shape)
            for k, v in build_model(cfg, device="meta").state_dict().items()}


def jax_leaves(cfg: ModelConfig) -> dict:
    """JAX leaf path -> `JaxLeaf` for every parameter of `cfg`'s model."""
    stacks = _stacks(cfg)
    out: dict = {}
    for name, shape in _port_shapes(cfg).items():
        group, _, rest = name.partition(".")
        stacked = group in stacks
        if stacked:
            path = f"{group}/{_layer_path(rest.partition('.')[2])}"
        elif group == "shared":
            path = f"shared/{_layer_path(rest)}"
        elif name in ("embed", "lm_head"):
            path = f"embedding/{name}"
        elif name in ("final_norm", "enc_final_norm"):
            path = f"{name}/scale"
        else:
            path = name
        names = out[path].names + (name,) if path in out else (name,)
        out[path] = JaxLeaf(names, stacked, (len(names), *shape) if stacked else shape)
    return out


def params_from_jax(tree: dict, cfg: ModelConfig) -> dict:
    """State dict for `build_model(cfg).load_state_dict(...)`."""
    want = _port_shapes(cfg)
    leaves = jax_leaves(cfg)
    flat = dict(_leaves(tree))
    extra = sorted(set(flat) - set(leaves))
    if extra:
        raise ValueError(f"JAX leaf {extra[0]} has no place in the port's model")
    missing = sorted(n for p in set(leaves) - set(flat) for n in leaves[p].names)
    if missing:
        raise ValueError(f"{cfg.name}: port weights the tree leaves empty {missing[:4]}")
    state = {}
    for path, leaf in leaves.items():
        a = np.asarray(flat[path])
        if not leaf.stacked:
            state[leaf.names[0]] = _tensor(a)
            continue
        if a.shape[0] != len(leaf.names):
            raise ValueError(f"{path} has {a.shape[0]} layers, config says "
                             f"{len(leaf.names)}")
        for name, layer in zip(leaf.names, a):
            state[name] = _tensor(layer)
    for k, t in state.items():
        if tuple(t.shape) != want[k]:
            raise ValueError(f"{k}: JAX shape {tuple(t.shape)}, port {want[k]}")
    return state
