"""The yardstick's operations and bytes against hand counts."""
import pytest

from bench import roofline

CFG = {"d_model": 8, "d_ff": 16, "n_heads": 4, "n_kv_heads": 2, "head_dim": 2,
       "n_layers": 3, "vocab_size": 10}


def test_token_flops_dense_and_moe():
    # attention: q 8x8, k 8x4, v 8x4, o 8x8 = 192 weights; MLP 3 * 8 * 16 = 384
    assert roofline.token_flops(CFG) == 2 * 3 * (192 + 384)
    moe = dict(CFG, moe={"n_experts": 4, "top_k": 2})
    # two experts of 384 weights and a router of 8 x 4
    assert roofline.token_flops(moe) == 2 * 3 * (192 + 2 * 384 + 32)


def test_step_flops_counts_valid_tokens_context_and_one_head_row():
    per_token = roofline.token_flops(CFG)
    head = 2 * 8 * 10
    # row 0: 2 tokens after 3 cached (they see 4 and 5 positions); row 1: idle
    attn = 3 * 4 * 4 * 2 * (4 + 5)
    assert roofline.step_flops(CFG, [3, 7], [2, 0]) == 2 * per_token + attn + head


def test_attend_work_by_hand():
    h, kh, hd = 4, 2, 2
    flops, n_bytes = roofline.attend_work([3, 5], [2, 0], h, kh, hd)
    assert flops == 4 * h * hd * (4 + 5)
    # cached K and V: 2*kh*hd*3 elements; q, k_new, v_new: 2*(h+2kh)*hd;
    # new K and V written: 2*2*kh*hd; output 2*h*hd; 2 bytes each
    assert n_bytes == 2 * hd * (2 * kh * 3 + 2 * (h + 2 * kh) + 2 * 2 * kh + 2 * h)


def test_k1_work_and_bound():
    ops, n_bytes = roofline.k1_work(8, 8192, 512)
    assert ops == 2 * 8 * 8192 * 512
    assert n_bytes == 8 * 512 + 8192 * 512 + 4 * 8 * 8192
    assert roofline.bound_s(ops, n_bytes, roofline.INT8_OPS_PER_S) == pytest.approx(
        n_bytes / roofline.HBM_BYTES_PER_S)
