"""Port kernels K1 (`dirc_mac`) and K2 (`score_matmul_int`) vs the JAX
Pallas kernels (interpret mode) and their oracles, bit-equal.

On the CPU the wrappers take the kernels' plain versions; the CUDA
kernels themselves are held against them on a card by
`tests/test_torch_cuda.py`."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_parity import int_codes, to_numpy, to_torch  # noqa: E402

from repro.core import bitplane as jb  # noqa: E402
from repro.kernels import dirc_mac as jdirc  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import bitplane as tb  # noqa: E402
from repro_torch.kernels import dirc_mac, ops, ref, score_matmul  # noqa: E402


@pytest.mark.parametrize("b,n,dim,bits", [
    (1, 128, 128, 8), (2, 300, 128, 8), (4, 515, 512, 4),
    (3, 130, 1024, 8), (1, 64, 256, 4), (8, 256, 128, 8),
])
def test_dirc_mac_bit_equal(b, n, dim, bits):
    rng = np.random.default_rng(b * 1000 + n)
    q, d = int_codes(rng, (b, dim), bits), int_codes(rng, (n, dim), bits)
    jp = jb.to_bitplanes(jnp.asarray(d), bits=bits)
    want = np.asarray(jops.dirc_mac(jnp.asarray(q), jb.pack_words(jp), bits=bits))
    np.testing.assert_array_equal(want, np.asarray(jref.dirc_mac(jnp.asarray(q), jp, bits)))
    tp = tb.to_bitplanes(to_torch(d), bits=bits)
    got = ops.dirc_mac(to_torch(q), tb.pack_words(tp), bits=bits)
    assert got.dtype == torch.int32 and got.shape == (b, n)
    np.testing.assert_array_equal(to_numpy(got), want)
    np.testing.assert_array_equal(to_numpy(ref.dirc_mac(to_torch(q), tp, bits)), want)


def test_dirc_mac_1d_query():
    rng = np.random.default_rng(7)
    q, d = int_codes(rng, (128,)), int_codes(rng, (100, 128))
    packed = tb.pack_words(tb.to_bitplanes(to_torch(d)))
    got = ops.dirc_mac(to_torch(q), packed)
    assert got.shape == (100,)
    want = np.asarray(jops.dirc_mac(jnp.asarray(q),
                                    jb.pack_words(jb.to_bitplanes(jnp.asarray(d)))))
    np.testing.assert_array_equal(to_numpy(got), want)
    np.testing.assert_array_equal(to_numpy(got), q.astype(np.int64) @ d.astype(np.int64).T)


def _random_planes(rng, b, n, dim, bits):
    """Random uint32 plane words in the kernel's layouts, as int32 tensors
    holding the bit pattern: any pattern is a code, as sensed flips give."""
    nw = dim // 32
    qw = rng.integers(0, 2**32, size=(b, bits, nw), dtype=np.uint64).astype(np.uint32)
    dw = rng.integers(0, 2**32, size=(bits, nw, n), dtype=np.uint64).astype(np.uint32)
    return qw, dw, torch.from_numpy(qw.view(np.int32)), torch.from_numpy(dw.view(np.int32))


@pytest.mark.parametrize("b,n,dim,bits", [
    (1, 128, 128, 8), (3, 256, 512, 4), (5, 128, 1024, 8), (2, 384, 256, 4),
    (8, 128, 512, 8),
])
def test_random_plane_words_are_a_code_dot(b, n, dim, bits):
    """The identity the CUDA K1 rests on: for ANY plane words, the
    weighted popcount sum equals the int64 dot product of the two's-
    complement codes the planes encode, in the port's plain version and
    in the JAX kernel (interpret mode)."""
    rng = np.random.default_rng(b * 7919 + n + dim + bits)
    qw, dw, qp, dp = _random_planes(rng, b, n, dim, bits)
    q = tb.from_bitplanes(tb.unpack_words(qp), bits).long()                  # (b, dim)
    d = tb.from_bitplanes(tb.unpack_words(dp.permute(2, 0, 1)), bits).long()  # (n, dim)
    lim = 1 << (bits - 1)
    assert int(q.min()) >= -lim and int(q.max()) < lim
    want = to_numpy(q @ d.T)
    np.testing.assert_array_equal(to_numpy(dirc_mac.dirc_mac_packed_ref(qp, dp, bits)), want)
    got_jax = jdirc.dirc_mac_packed(jnp.asarray(qw), jnp.asarray(dw), bits=bits,
                                    interpret=True)
    np.testing.assert_array_equal(np.asarray(got_jax).astype(np.int64), want)


def _decode_word(P):
    """The CUDA K1's decode of one 32-dim word (`decode_word` in
    csrc/dirc_mac.cu), step for step on uint32 arrays: three rounds of
    delta swaps between rows of the 8 x 32 bit matrix whose row b is plane
    b. Returns the 8 words it leaves: byte y of word x is the code of dim
    8y + x."""
    P = [p.astype(np.uint32) for p in P]

    def swap(a, b, s, mask):
        t = ((P[a] >> np.uint32(s)) ^ P[b]) & np.uint32(mask)
        P[b] = P[b] ^ t
        P[a] = P[a] ^ (t << np.uint32(s))
    for r in range(4):
        swap(r, r + 4, 4, 0x0F0F0F0F)
    for r in (0, 1, 4, 5):
        swap(r, r + 2, 2, 0x33333333)
    for r in (0, 2, 4, 6):
        swap(r, r + 1, 1, 0x55555555)
    return P


@pytest.mark.parametrize("bits", [4, 8])
def test_k1_decode_model_transposes_the_planes(bits):
    """The kernel's bit-matrix transpose (with the sign plane copied into
    planes bits..7 for INT4) gives the codes `from_bitplanes` decodes, in
    the order x, 8+x, 16+x, 24+x within word x; permuting queries and docs
    alike leaves their dot product as it is."""
    rng = np.random.default_rng(bits)
    words = rng.integers(0, 2**32, size=(bits, 4096), dtype=np.uint64).astype(np.uint32)
    words[:, 0] = 0xFFFFFFFF                      # all ones: code -1 in every dim
    words[:, 1] = 0
    words[bits - 1, 1] = 0xFFFFFFFF               # sign plane only: the most negative code
    P = [words[min(b, bits - 1)] for b in range(8)]
    codes = np.stack(_decode_word(P), axis=-1)                       # (4096, 8 words)
    got = codes.view(np.int8).reshape(4096, 32)                      # byte 4x + y
    perm = np.array([8 * y + x for x in range(8) for y in range(4)])
    per_word = torch.from_numpy(words.T.copy().view(np.int32))[..., None]
    want = to_numpy(tb.from_bitplanes(tb.unpack_words(per_word), bits))    # (4096, 32)
    np.testing.assert_array_equal(got, want[:, perm])
    assert (got[0] == -1).all() and (got[1] == -(1 << (bits - 1))).all()
    a, c = got[2:2050].astype(np.int64), got[2050:].astype(np.int64)
    np.testing.assert_array_equal(a @ c.T, want[2:2050].astype(np.int64)
                                  @ want[2050:].astype(np.int64).T)


@pytest.mark.parametrize("b,n,dim", [(1, 128, 128), (3, 257, 384), (2, 1000, 512),
                                   (72, 131, 48)])
def test_score_matmul_bit_equal(b, n, dim):
    rng = np.random.default_rng(n)
    q, d = int_codes(rng, (b, dim)), int_codes(rng, (n, dim))
    want = np.asarray(jops.score_matmul(jnp.asarray(q), jnp.asarray(d)))
    np.testing.assert_array_equal(
        want, np.asarray(jref.score_matmul_int(jnp.asarray(q), jnp.asarray(d))))
    got = ops.score_matmul(to_torch(q), to_torch(d))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(to_numpy(got), want)
    np.testing.assert_array_equal(to_numpy(ref.score_matmul_int(to_torch(q), to_torch(d))),
                                  want)
    got1 = ops.score_matmul(to_torch(q[0]), to_torch(d))
    assert got1.shape == (n,)
    np.testing.assert_array_equal(to_numpy(got1), want[0])


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    """A CPU tensor never reaches the kernel library or its launch count."""
    from repro_torch.kernels import _build

    def refuse():
        raise AssertionError("CPU tensors must not load the CUDA library")

    monkeypatch.setattr(_build, "load_library", refuse)
    monkeypatch.setattr(dirc_mac, "LAUNCHES", 0)
    monkeypatch.setattr(score_matmul, "LAUNCHES", 0)
    rng = np.random.default_rng(8)
    q, d = int_codes(rng, (2, 128)), int_codes(rng, (300, 128))
    qp = tb.pack_words(tb.to_bitplanes(to_torch(q)))
    dp = tb.pack_words(tb.to_bitplanes(to_torch(d))).permute(1, 2, 0).contiguous()
    k1 = dirc_mac.dirc_mac_packed(qp, dp, 8)
    np.testing.assert_array_equal(to_numpy(k1),
                                  to_numpy(dirc_mac.dirc_mac_packed_ref(qp, dp, 8)))
    k2 = score_matmul.score_matmul_int(to_torch(q), to_torch(d))
    np.testing.assert_array_equal(to_numpy(k1), to_numpy(k2))
    assert dirc_mac.LAUNCHES == 0 and score_matmul.LAUNCHES == 0


def test_wrappers_validate_inputs():
    with pytest.raises(TypeError):
        score_matmul.score_matmul_int(torch.zeros(2, 32), torch.zeros(4, 32))
    with pytest.raises(ValueError):
        score_matmul.score_matmul_int(torch.zeros(2, 32, dtype=torch.int8),
                                      torch.zeros(4, 16, dtype=torch.int8))
    with pytest.raises(TypeError):
        dirc_mac.dirc_mac_packed(torch.zeros(1, 8, 4), torch.zeros(8, 4, 5), 8)
    with pytest.raises(ValueError):
        dirc_mac.dirc_mac_packed(torch.zeros(1, 8, 4, dtype=torch.int32),
                                 torch.zeros(4, 4, 5, dtype=torch.int32), 8)


def test_launch_counters_read_and_reset_under_one_lock():
    """`kernels.counters` reads every wrapper's count at one instant and
    zeroes them all; the plain path on the CPU counts nothing."""
    from repro_torch.kernels import counters, paged_attend

    counters.reset()
    assert set(counters.read().values()) == {0}
    with counters.LOCK:
        paged_attend.LAUNCHES += 3
        paged_attend.COMBINE_LAUNCHES += 2
        paged_attend.PREFILL_LAUNCHES += 1
    got = counters.read()
    assert (got["paged_attend_fused"], got["paged_combine"], got["paged_attend_prefill"],
            got["dirc_mac"]) == (3, 2, 1, 0)
    rng = np.random.default_rng(0)
    q, d = int_codes(rng, (2, 128), 8), int_codes(rng, (64, 128), 8)
    score_matmul.score_matmul_int(to_torch(q), to_torch(d))   # the plain path
    assert counters.read()["score_matmul_int"] == 0
    counters.reset()
    assert set(counters.read().values()) == {0}
