"""The model's weights, made from the seed on the device in the dtype
they are served in.

A model is a list of groups: the head (embedding, final norm, an untied
head) and one group per layer. Each group draws from a generator of its
own, seeded by the run's seed and the group's index, so any one group
can be made again alone and comes out bit for bit the same: the harness
fills the port's parameters with `fill`, and the reference makes each
layer again with `make` once the port is gone. Stds are the usual ones:
input projections d^-1/2 (queries and keys wider, `QK_GAIN`), output
projections (width)^-1/2 / sqrt(2 L) (attention's narrower, `WO_GAIN`),
the embedding 0.02, norm scales 1; a MoE layer's experts share part of
their draw (`EXPERT_SPREAD`).
"""
from __future__ import annotations

import hashlib
import math

import torch

# Two gains on the usual stds keep greedy answers diverse and the model
# well conditioned. With the plain stds a 4k-token context's attention
# is nearly flat: every position reads the mean of the values, the
# residual streams share that direction, and greedy answers collapse to
# a token or two repeated (2-8 distinct tokens in 200-480 served, on the
# card), too few decisions for the comparison to tell a lower precision
# from the model. Queries and keys QK_GAIN times wider sharpen attention;
# the attention output WO_GAIN times narrower leaves each position's
# own path in charge. At QK_GAIN 3 the model is chaotic: bf16 and fp32
# part at nearly every served token (on the card). At 1.5 and 0.25 a
# 32-layer model at d 256 answers with every token distinct, and its
# emulated bf16 run parts from fp32 at 2 of 48 positions by at most
# 0.015, fp8 at 38 by up to 0.58 (on the CPU).
QK_GAIN = 1.5
WO_GAIN = 0.25
# A MoE layer's experts are a shared matrix plus EXPERT_SPREAD times one
# of their own (rescaled to the usual std). Top-k routing is
# discontinuous: a token near a tie between its k-th and (k+1)-th expert
# routes by the rounding, in bf16 as in any precision, and the further
# apart the experts, the further that one choice moves the token. On the
# card (phi3.5-moe, 16 layers, ~480 served tokens a seed), experts drawn
# alone left 44% of the served tokens off the fp32 reference's best (by
# up to 9.3 logits), as far as the fp8 control (60%, 9.0); at a spread
# of 0.3, 19-20% against 60-62%; at 0.1, 9-10% against 44-51%.
EXPERT_SPREAD = 0.1

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def padded_vocab(cfg: dict) -> int:
    return (int(cfg["vocab_size"]) + 255) // 256 * 256


def groups(cfg: dict) -> list[list[tuple[str, tuple, object]]]:
    """[[(name, shape, std or "ones"), ...] per group]: the head first,
    then each layer; names are the port's parameter names."""
    d, L, f = cfg["d_model"], cfg["n_layers"], cfg["d_ff"]
    h, kh, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    head = [("embed", (padded_vocab(cfg), d), 0.02), ("final_norm", (d,), "ones")]
    if not cfg["tie_embeddings"]:
        head.append(("lm_head", (d, padded_vocab(cfg)), d ** -0.5))
    out = [head]
    down = f ** -0.5 / math.sqrt(2 * L)
    for i in range(L):
        p = f"blocks.{i}."
        g = [(p + "attn_norm", (d,), "ones"),
             (p + "wq", (d, h * hd), QK_GAIN * d ** -0.5),
             (p + "wk", (d, kh * hd), QK_GAIN * d ** -0.5),
             (p + "wv", (d, kh * hd), d ** -0.5),
             (p + "wo", (h * hd, d), WO_GAIN * (h * hd) ** -0.5 / math.sqrt(2 * L)),
             (p + "mlp_norm", (d,), "ones")]
        moe = cfg.get("moe")
        if moe:
            E = moe["n_experts"]
            g += [(p + "moe.router", (d, E), d ** -0.5),
                  (p + "moe.w_gate", (E, d, f), d ** -0.5), (p + "moe.w_up", (E, d, f), d ** -0.5),
                  (p + "moe.w_down", (E, f, d), down)]
        else:
            g += [(p + "mlp.w_gate", (d, f), d ** -0.5), (p + "mlp.w_up", (d, f), d ** -0.5),
                  (p + "mlp.w_down", (f, d), down)]
        out.append(g)
    return out


def group_seed(seed: int, group: int) -> int:
    digest = hashlib.sha256(f"{int(seed)}:{group}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def _experts(t: torch.Tensor, std: float, g: torch.Generator) -> None:
    """(E, ...) expert weights: a shared draw plus EXPERT_SPREAD times each
    expert's own, scaled to `std`."""
    base = torch.empty(t.shape[1:], dtype=torch.float32, device=t.device).normal_(generator=g)
    scale = std / (1.0 + EXPERT_SPREAD ** 2) ** 0.5
    for e in range(t.shape[0]):
        own = torch.empty_like(base).normal_(generator=g)
        t[e] = ((base + EXPERT_SPREAD * own) * scale).to(t.dtype)


@torch.no_grad()
def fill(tensors: dict, plan: list, seed: int, group: int) -> None:
    """Fill `tensors` {name: tensor} with group `group`'s draws."""
    dev = next(iter(tensors.values())).device
    g = torch.Generator(device=dev)
    g.manual_seed(group_seed(seed, group))
    for name, shape, std in plan:
        t = tensors[name]
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: the port holds {tuple(t.shape)}, the plan {shape}")
        if std == "ones":
            t.fill_(1.0)
        elif ".moe.w_" in name:
            _experts(t, std, g)
        else:
            t.normal_(0.0, std, generator=g)


def make(cfg: dict, seed: int, group: int, device: torch.device) -> dict:
    """Group `group` made again: {name: tensor} in the served dtype."""
    plan = groups(cfg)[group]
    dtype = DTYPES[cfg["param_dtype"]]
    tensors = {n: torch.empty(s, dtype=dtype, device=device) for n, s, _ in plan}
    fill(tensors, plan, seed, group)
    return tensors


def fill_model(model: torch.nn.Module, cfg: dict, seed: int) -> None:
    """Fill every parameter of the port's `model` from the seed, a group
    at a time; checks that the plan names every parameter once."""
    params = dict(model.named_parameters())
    plan = groups(cfg)
    named = [n for g in plan for n, _, _ in g]
    if sorted(named) != sorted(params):
        raise ValueError(f"the port's parameters {sorted(set(params) ^ set(named))} "
                         "differ from the weight plan")
    for i, g in enumerate(plan):
        fill({n: params[n].data for n, _, _ in g}, g, seed, i)
