"""The yardstick: the card's published peaks and the operations and bytes
that a step, a K3 call and a K1 call need, counted from their shapes.

Peaks: NVIDIA's H100 SXM data sheet, dense rates (bf16 989 TFLOP/s, int8
1,979 TOP/s, HBM3 3.35 TB/s), at the full 700 W power limit.

The model's count is the forward-only form of `2 N D` (the arithmetic of
the port's `perf.roofline.model_flops` and `attention_flops`, frozen
here): per valid token, 2 multiply-adds per weight it meets (attention
projections; the MLP, or the router and top-k experts of a MoE layer),
plus 4 h hd per visible earlier position for attention's scores and
values; per row, the head's 2 d V at its last valid position, which is
the only one the step projects. Padding tokens and unrouted experts are
not useful work and are not counted.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
INT8_OPS_PER_S = 1979e12


def token_flops(cfg: dict) -> float:
    """Weight FLOPs a token costs, summed over the layers."""
    d, f = cfg["d_model"], cfg["d_ff"]
    h, kh, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    attn = d * hd * (h + 2 * kh) + h * hd * d
    moe = cfg.get("moe")
    mlp = (moe["top_k"] * 3 * d * f + d * moe["n_experts"]) if moe else 3 * d * f
    return 2.0 * cfg["n_layers"] * (attn + mlp)


def step_flops(cfg: dict, lengths, n_valid) -> float:
    """Useful FLOPs of one paged step: row b adds its n_valid[b] tokens
    after lengths[b] cached ones."""
    h, hd, L = cfg["n_heads"], cfg["head_dim"], cfg["n_layers"]
    per_token = token_flops(cfg)
    head = 2.0 * cfg["d_model"] * cfg["vocab_size"]
    total = 0.0
    for length, n in zip(lengths, n_valid):
        n, length = int(n), int(length)
        if n <= 0:
            continue
        # token i (0-based) of the row sees length + i + 1 positions
        visible = n * length + n * (n + 1) / 2
        total += n * per_token + L * 4.0 * h * hd * visible + head
    return total


def attend_work(lengths, n_valid, h: int, kh: int, hd: int, elem: int = 2):
    """(FLOPs, bytes) of one K3 call over the valid rows: the scores and
    values of every new token against its visible positions; the cached
    K/V read once, the new queries, keys and values read, the new K/V
    written to the pool and the output written."""
    flops = n_bytes = 0.0
    for length, n in zip(lengths, n_valid):
        n, length = int(n), int(length)
        if n <= 0:
            continue
        flops += 4.0 * h * hd * (n * length + n * (n + 1) / 2)
        n_bytes += elem * hd * (2 * kh * length          # cached K and V read
                                + n * (h + 2 * kh)       # q, k_new, v_new read
                                + n * 2 * kh             # new K and V written
                                + n * h)                 # output written
    return flops, n_bytes


def bound_s(flops: float, n_bytes: float, peak: float = BF16_FLOP_PER_S) -> float:
    """The least time on the card: the larger of operations over the peak
    and bytes over the memory rate."""
    return max(flops / peak, n_bytes / HBM_BYTES_PER_S)


def k1_work(b: int, n: int, dim: int, bits: int = 8):
    """(int8 operations, bytes) of one K1 call: 2 b n dim operations; the
    query and document planes read once, the (b, n) int32 output written."""
    return 2.0 * b * n * dim, b * dim * bits / 8 + n * dim * bits / 8 + 4.0 * b * n
