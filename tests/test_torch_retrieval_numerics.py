"""Port vs JAX: quantization, bit-planes, packed words, the bit-serial MAC
and top-k — all bit-equal (integer math) or identical (top-k ids)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_parity import int_codes, to_numpy, to_torch, unit_rows  # noqa: E402

from repro.core import bitplane as jb  # noqa: E402
from repro.core import quantization as jq  # noqa: E402
from repro.core import topk as jt  # noqa: E402
from repro_torch.core import bitplane as tb  # noqa: E402
from repro_torch.core import quantization as tq  # noqa: E402
from repro_torch.core import topk as tt  # noqa: E402


# ------------------------------------------------------------ quantization
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("per_row", [True, False])
def test_quantize_bit_equal(bits, per_row):
    """Unit-norm rows at the paper's width: the scale must be absmax times
    the float32 reciprocal of qmax, as XLA computes it (trouble spot T1)."""
    rng = np.random.default_rng(bits)
    x = unit_rows(rng, 2048, 512)
    x[3] = 0.0                                    # zero row -> scale 1
    x[5] *= 1e-3
    jr = jq.quantize(jnp.asarray(x), bits=bits, per_row=per_row)
    tr = tq.quantize(to_torch(x), bits=bits, per_row=per_row)
    np.testing.assert_array_equal(to_numpy(tr.values), np.asarray(jr.values))
    assert to_numpy(tr.scale).tobytes() == np.asarray(jr.scale).tobytes()
    assert tr.values.dtype == torch.int8 and tr.bits == bits


@pytest.mark.parametrize("shape", [(128,), (5, 128)])
@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_query_bit_equal(shape, bits):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    jr = jq.quantize_query(jnp.asarray(x), bits=bits)
    tr = tq.quantize_query(to_torch(x), bits=bits)
    np.testing.assert_array_equal(to_numpy(tr.values), np.asarray(jr.values))
    assert to_numpy(tr.scale).tobytes() == np.asarray(jr.scale).tobytes()
    np.testing.assert_array_equal(to_numpy(tr.dequantize()),
                                  np.asarray(jr.dequantize()))


def test_quantize_rejects_unsupported_bits():
    with pytest.raises(ValueError):
        tq.quantize(torch.zeros(2, 4), bits=2)


# -------------------------------------------------------------- bit-planes
@pytest.mark.parametrize("bits", [4, 8])
def test_bitplanes_and_packed_words_bit_equal(bits):
    rng = np.random.default_rng(2)
    v = int_codes(rng, (37, 256), bits)
    jp = jb.to_bitplanes(jnp.asarray(v), bits=bits)
    tp = tb.to_bitplanes(to_torch(v), bits=bits)
    np.testing.assert_array_equal(to_numpy(tp), np.asarray(jp))
    np.testing.assert_array_equal(to_numpy(tb.from_bitplanes(tp, bits=bits)), v)
    np.testing.assert_array_equal(to_numpy(tb.sum_d_lut(tp)),
                                  np.asarray(jb.sum_d_lut(jp)))
    # packed words: int32 tensors holding the uint32 bit pattern (T2)
    jw = np.asarray(jb.pack_words(jp))
    tw = tb.pack_words(tp)
    assert tw.dtype == torch.int32
    np.testing.assert_array_equal(to_numpy(tw).view(np.uint32), jw)
    np.testing.assert_array_equal(to_numpy(tb.unpack_words(tw)),
                                  np.asarray(jb.unpack_words(jnp.asarray(jw))))


def test_pack_words_high_bit_patterns():
    """Words with bit 31 set (negative as int32) round-trip exactly."""
    planes = np.zeros((3, 64), np.uint8)
    planes[0, 31] = 1
    planes[1, :] = 1
    planes[2, 32:] = 1
    tw = tb.pack_words(to_torch(planes))
    np.testing.assert_array_equal(to_numpy(tw).view(np.uint32),
                                  np.asarray(jb.pack_words(jnp.asarray(planes))))
    np.testing.assert_array_equal(to_numpy(tb.unpack_words(tw)), planes)


@pytest.mark.parametrize("case", ["random8", "random4", "query1d", "extreme1024"])
def test_bitserial_dot_and_int_inner_product_bit_equal(case):
    """Including dim 1024 with every code -128, where |dot| = 2^24 — the
    largest value the JAX float32 einsum still gets exactly (T4)."""
    rng = np.random.default_rng(3)
    bits = 4 if case == "random4" else 8
    if case == "extreme1024":
        q = np.full((2, 1024), -128, np.int8)
        d = np.full((5, 1024), -128, np.int8)
    elif case == "query1d":
        q, d = int_codes(rng, (128,)), int_codes(rng, (40, 128))
    else:
        q, d = int_codes(rng, (3, 256), bits), int_codes(rng, (50, 256), bits)
    jp = jb.to_bitplanes(jnp.asarray(d), bits=bits)
    got = tb.bitserial_dot(to_torch(q), to_torch(np.asarray(jp)), bits=bits)
    want = np.asarray(jb.bitserial_dot(jnp.asarray(q), jp, bits=bits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(to_numpy(got), want)
    ip = tq.int_inner_product(to_torch(q), to_torch(d))
    np.testing.assert_array_equal(
        to_numpy(ip), np.asarray(jq.int_inner_product(jnp.asarray(q), jnp.asarray(d))))
    if case == "extreme1024":
        assert int(got.max()) == 2**24


# ------------------------------------------------------------------ top-k
def _score_sets():
    rng = np.random.default_rng(4)
    return {
        "random": rng.normal(size=(3, 256)).astype(np.float32),
        "all_equal": np.zeros((2, 256), np.float32),
        "repeated": rng.integers(0, 4, size=(3, 256)).astype(np.float32),
    }


@pytest.mark.parametrize("name", ["random", "all_equal", "repeated"])
@pytest.mark.parametrize("k", [1, 5, 20])
def test_topk_identical(name, k):
    s = _score_sets()[name]
    jl = jt.local_topk(jnp.asarray(s), k)
    tl = tt.local_topk(to_torch(s), k)
    np.testing.assert_array_equal(to_numpy(tl.indices), np.asarray(jl.indices))
    np.testing.assert_array_equal(to_numpy(tl.scores), np.asarray(jl.scores))
    jh = jt.hierarchical_topk(jnp.asarray(s), k, n_cores=16)
    th = tt.hierarchical_topk(to_torch(s), k, n_cores=16)
    np.testing.assert_array_equal(to_numpy(th.indices), np.asarray(jh.indices))
    np.testing.assert_array_equal(to_numpy(th.scores), np.asarray(jh.scores))
    np.testing.assert_array_equal(to_numpy(th.indices), to_numpy(tl.indices))


@pytest.mark.parametrize("name", ["random", "all_equal", "repeated"])
def test_merge_candidates_identical(name):
    s = _score_sets()[name][:, :64]
    ids = np.stack([np.random.default_rng(i).permutation(1000)[:64]
                    for i in range(s.shape[0])]).astype(np.int32)
    jm = jt.merge_candidates(jnp.asarray(s), jnp.asarray(ids), 10)
    tm = tt.merge_candidates(to_torch(s), to_torch(ids), 10)
    np.testing.assert_array_equal(to_numpy(tm.indices), np.asarray(jm.indices))
    np.testing.assert_array_equal(to_numpy(tm.scores), np.asarray(jm.scores))


def test_precision_at_k_equal():
    rng = np.random.default_rng(5)
    retrieved = rng.integers(0, 20, size=(6, 10)).astype(np.int32)
    relevant = rng.integers(-1, 20, size=(6, 4)).astype(np.int32)
    want = float(jt.precision_at_k(jnp.asarray(retrieved), jnp.asarray(relevant), 5))
    got = float(tt.precision_at_k(to_torch(retrieved), to_torch(relevant), 5))
    assert got == pytest.approx(want, rel=1e-6)
