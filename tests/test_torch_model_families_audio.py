"""Port vs JAX: `EncDecLM` (whisper-small) at smoke size in fp32 with the
same (converted) weights — `encode` over the stub frame embeddings,
`forward` (teacher-forced decode over the encoded frames),
`precompute_cross`, and `decode_step` with the precomputed cross K/V and
with the zero ones `init_caches` leaves (what every serving path
attends to: its cross-attention term is exactly 0) (`_torch_ssm`)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_numpy, to_torch
from _torch_ssm import TOL, check_decode, models, prompts
from repro_torch.models import EncDecLM, supports_paged_kv

ARCH = "whisper-small"
_JIT: dict = {}


def _jax(name):
    jmodel = models(ARCH)[0]
    if name not in _JIT:
        _JIT[name] = jax.jit(getattr(jmodel, name))
    return _JIT[name]


def _frames(b=2, seed=6):
    e = models(ARCH)[3].cfg.encoder
    return np.random.default_rng(seed).normal(size=(b, e.n_frames, e.d_model)).astype(
        np.float32)


def test_encode_forward_and_precompute_cross():
    _, params, _, tmodel = models(ARCH)
    assert isinstance(tmodel, EncDecLM) and not supports_paged_kv(tmodel)
    frames = _frames()
    enc = tmodel.encode(to_torch(frames))
    want = _jax("encode")(params, jnp.asarray(frames))
    np.testing.assert_allclose(to_numpy(enc), np.asarray(want), **TOL)
    toks = prompts(2, 20, tmodel.cfg.vocab_size, seed=7)   # not a chunk multiple
    got = tmodel.forward(to_torch(toks).long(), to_torch(frames))
    jl, _ = _jax("forward")(params, jnp.asarray(toks), jnp.asarray(frames))
    np.testing.assert_allclose(to_numpy(got), np.asarray(jl), **TOL)
    k, v = tmodel.precompute_cross(enc)
    jk, jv = _jax("precompute_cross")(params, want)
    np.testing.assert_allclose(to_numpy(k), np.asarray(jk), **TOL)
    np.testing.assert_allclose(to_numpy(v), np.asarray(jv), **TOL)


def test_decode_with_precomputed_cross_continues_the_forward():
    """encode -> precompute_cross -> decode_step over the tokens: logits
    against the JAX decode each step and, at the end, the forward's last."""
    _, params, jdec, tmodel = models(ARCH)
    frames = _frames(seed=8)
    toks = prompts(2, 10, tmodel.cfg.vocab_size, seed=9)
    enc = tmodel.encode(to_torch(frames))
    k, v = tmodel.precompute_cross(enc)
    tc = tmodel.init_caches(2, 16, 0)._replace(cross_k=k, cross_v=v)
    jk, jv = _jax("precompute_cross")(params, jnp.asarray(to_numpy(enc)))
    jc = models(ARCH)[0].init_caches(2, 16, 0)._replace(cross_k=jk, cross_v=jv)
    for t in range(10):
        tl, tc = tmodel.decode_step(tc, to_torch(toks[:, t:t + 1]).long())
        jl, jc = jdec(params, jc, jnp.asarray(toks[:, t:t + 1]))
        np.testing.assert_allclose(to_numpy(tl), np.asarray(jl), **TOL)
    full = tmodel.forward(to_torch(toks).long(), to_torch(frames))
    np.testing.assert_allclose(to_numpy(tl), to_numpy(full)[:, -1], **TOL)


def test_decode_with_zero_cross_caches():
    """From `init_caches`' zero cross K/V (the serving paths): 8 steps
    against JAX, and the cross term is 0 — the same logits as with the
    cross weights themselves zeroed."""
    check_decode(ARCH)
    tmodel = models(ARCH)[3]
    toks = prompts(2, 4, tmodel.cfg.vocab_size, seed=10)
    a = tmodel.init_caches(2, 8, 0)
    for t in range(4):
        la, a = tmodel.decode_step(a, to_torch(toks[:, t:t + 1]).long())
    saved = [blk.cross.wo.clone() for blk in tmodel.decoder]
    try:
        with torch.no_grad():
            for blk in tmodel.decoder:
                blk.cross.wo.zero_()
        b = tmodel.init_caches(2, 8, 0)
        for t in range(4):
            lb, b = tmodel.decode_step(b, to_torch(toks[:, t:t + 1]).long())
    finally:
        with torch.no_grad():
            for blk, w in zip(tmodel.decoder, saved):
                blk.cross.wo.copy_(w)
    assert torch.equal(la, lb)


@pytest.mark.parametrize("b", [1, 3])
def test_init_caches_batch_axes(b):
    """Every leaf's batch axis is 1 (the layer axis first), length's 0."""
    c = models(ARCH)[3].init_caches(b, 12, 5)
    e = models(ARCH)[3].cfg.encoder
    assert c.self_k.shape[:3] == (2, b, 12) and c.cross_v.shape[:3] == (2, b, e.n_frames)
    assert c.length.tolist() == [5] * b
