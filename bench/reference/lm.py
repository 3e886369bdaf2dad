"""The language model's forward pass over whole sequences, in plain
PyTorch: no cache, no batching, no kernel of the port.

Pre-norm blocks: x + attention(rmsnorm(x)), then + ffn(rmsnorm(x)).
Attention: grouped-query (query head j reads KV head j // (h / kh)),
split-half RoPE at angles computed in float64, causal softmax over every
earlier position. The ffn is a SwiGLU MLP, or a top-k mixture of
SwiGLU experts: softmax router probabilities, the k largest (the lower
expert first on a tie) renormalised to sum to 1, every routed token
computed by its experts (no capacity, no dropped token). The head is
the embedding's transpose, or an untied matrix, over the real
vocabulary.

`precision="fp32"` is the reference: weights cast to float32, every
matmul in float32 with TF32 off. `precision="fp8"` is the control of
the comparison: every weight matrix of the projections, the experts
and the head is rounded to float8 e4m3 with a scale per output column,
and every matmul input activation to e4m3 with a scale per row, as an
fp8 serving path would hold them; the router, the norms and attention's
own products stay in float32.

The weights come from `weights(group)` ({name: tensor} in the served
dtype: group 0 the head, group i + 1 layer i), one layer held at a time,
so a model larger than a card's memory in float32 still fits.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


@contextlib.contextmanager
def fp32_matmuls():
    """Float32 matmuls at full precision (TF32 off) inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """t rounded to e4m3 with one scale per slice along `dim`'s
    complement (the amax over `dim`), back in float32."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class _Precision:
    def __init__(self, precision: str):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.fp8 = precision == "fp8"

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A (..., in, out) weight in float32; fp8: a scale per column."""
        w = w.float()
        return fp8_round(w, dim=-2) if self.fp8 else w

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """A matmul's (rows, in) input; fp8: a scale per row."""
        return fp8_round(x, dim=-1) if self.fp8 else x


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, heads, hd) at positions 0 .. T-1, split-half rotation."""
    T, _, hd = x.shape
    half = hd // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang).float()[:, None], torch.sin(ang).float()[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              block: int = 1024) -> torch.Tensor:
    """Causal GQA: q (T, h, hd), k and v (T, kh, hd) -> (T, h * hd)."""
    T, h, hd = q.shape
    kh = k.shape[1]
    g = h // kh
    qg = q.reshape(T, kh, g, hd).permute(1, 2, 0, 3) * hd ** -0.5     # (kh, g, T, hd)
    kt, vt = k.permute(1, 0, 2), v.permute(1, 0, 2)                   # (kh, T, hd)
    out = torch.empty((kh, g, T, hd), dtype=q.dtype, device=q.device)
    pos = torch.arange(T, device=q.device)
    for lo in range(0, T, block):
        hi = min(lo + block, T)
        s = torch.einsum("kgtd,ksd->kgts", qg[:, :, lo:hi], kt[:, :hi])
        s = s.masked_fill(pos[None, :hi] > pos[lo:hi, None], float("-inf"))
        out[:, :, lo:hi] = torch.einsum("kgts,ksd->kgtd", torch.softmax(s, dim=-1), vt[:, :hi])
    return out.permute(2, 0, 1, 3).reshape(T, h * hd)


def swiglu(p: _Precision, x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor) -> torch.Tensor:
    a = p.act(x)
    return p.act(F.silu(a @ wg) * (a @ wu)) @ wd


def moe(cfg: dict, p: _Precision, w: dict, x: torch.Tensor) -> torch.Tensor:
    m = cfg["moe"]
    probs = torch.softmax(x @ w["moe.router"].float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :m["top_k"]], idx[:, :m["top_k"]]
    gates = vals / vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    y = torch.zeros_like(x)
    for e in range(m["n_experts"]):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel():
            out = swiglu(p, x[rows], p.weight(w["moe.w_gate"][e]), p.weight(w["moe.w_up"][e]),
                         p.weight(w["moe.w_down"][e]))
            y.index_add_(0, rows, out * gates[rows, slot, None])
    return y


def block(cfg: dict, p: _Precision, w: dict, x: torch.Tensor) -> torch.Tensor:
    T = x.shape[0]
    h, kh, hd, eps = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"], cfg["norm_eps"]
    a = p.act(rmsnorm(x, w["attn_norm"].float(), eps))
    q = rope((a @ p.weight(w["wq"])).reshape(T, h, hd), cfg["rope_theta"])
    k = rope((a @ p.weight(w["wk"])).reshape(T, kh, hd), cfg["rope_theta"])
    v = (a @ p.weight(w["wv"])).reshape(T, kh, hd)
    x = x + p.act(attention(q, k, v)) @ p.weight(w["wo"])
    n = rmsnorm(x, w["mlp_norm"].float(), eps)
    if cfg.get("moe"):
        return x + moe(cfg, p, w, n)
    return x + swiglu(p, n, p.weight(w["mlp.w_gate"]), p.weight(w["mlp.w_up"]),
                      p.weight(w["mlp.w_down"]))


@torch.no_grad()
def logits_at(cfg: dict, weights: Callable[[int], dict], seqs: Sequence[Sequence[int]],
              reads: Sequence[Sequence[int]], device: torch.device,
              precision: str = "fp32") -> list[torch.Tensor]:
    """For each token sequence, the float32 logits over the real
    vocabulary (len(reads[i]), V) at positions `reads[i]` (the logits at
    position j score the token at j + 1)."""
    p = _Precision(precision)
    V, eps = cfg["vocab_size"], cfg["norm_eps"]
    with fp32_matmuls():
        head = weights(0)
        xs = [head["embed"][torch.as_tensor(list(s), device=device)].float() for s in seqs]
        for i in range(cfg["n_layers"]):
            w = {n.split(".", 2)[2]: t for n, t in weights(i + 1).items()}
            xs = [block(cfg, p, w, x) for x in xs]
            del w
        if cfg["tie_embeddings"]:
            out_w = head["embed"][:V].float().T                             # (d, V)
        else:
            out_w = head["lm_head"][:, :V].float()
        out_w = p.weight(out_w)
        final = head["final_norm"].float()
        return [p.act(rmsnorm(x[torch.as_tensor(list(r), device=device)], final, eps)) @ out_w
                for x, r in zip(xs, reads)]
