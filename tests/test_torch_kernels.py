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


@pytest.mark.parametrize("b,n,dim", [(1, 128, 128), (3, 257, 384), (2, 1000, 512)])
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
