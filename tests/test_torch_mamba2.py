"""Port vs JAX: the Mamba2 / SSD pieces of `repro_torch.models.mamba2`
and `layers.gated_rmsnorm`, on the same numpy-seeded inputs.

fp32 within the JAX package's own tolerance (rtol 3e-4 / atol 3e-5,
tests/test_mamba2.py); the chunked SSD also against a naive per-step
recurrence. bf16: the conv's tap products and partial sums round to
bf16 in the port while XLA on the CPU may keep a fused sum in fp32, so a
whole block is held to 2e-2 of the output's largest magnitude (a few
bf16 ulps)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_numpy, to_torch
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import SSMConfig as JaxSSMConfig
from repro.models import layers as jax_layers
from repro.models import mamba2 as JM
from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.models import layers, mamba2 as TM
from repro_torch.models.convert import _tensor

TOL = dict(rtol=3e-4, atol=3e-5)
# the JAX block functions, jitted once per config (eager JAX is slow here)
j_apply = jax.jit(JM.apply_mamba_block, static_argnums=0, static_argnames="return_state")
j_decode = jax.jit(JM.decode_mamba_block, static_argnums=0)


def _naive_ssd(x, dt, A, B, C):
    """The recurrence one step at a time in float64 (heads grouped g-major:
    head j reads group j // r)."""
    b, s, h, p = x.shape
    g, n = B.shape[-2:]
    r = h // g
    state = np.zeros((b, h, p, n))
    ys = np.zeros((b, s, h, p))
    Bh, Ch = np.repeat(B, r, axis=2), np.repeat(C, r, axis=2)
    for t in range(s):
        dA = np.exp(dt[:, t] * A)
        state = state * dA[..., None, None] + (
            dt[:, t, :, None, None] * x[:, t, :, :, None] * Bh[:, t, :, None, :])
        ys[:, t] = np.einsum("bhpn,bhn->bhp", state, Ch[:, t])
    return ys, state


def _ssd_inputs(rng, g, s=32, b=2, h=4, p=8, n=16):
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, size=(b, s, h)).astype(np.float32)
    A = -rng.uniform(0.5, 2, size=(h,)).astype(np.float32)
    B = rng.normal(size=(b, s, g, n)).astype(np.float32)
    C = rng.normal(size=(b, s, g, n)).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("chunk", [4, 8, 32])
@pytest.mark.parametrize("g", [1, 2])
def test_ssd_chunked_vs_jax_and_recurrence(chunk, g):
    ins = _ssd_inputs(np.random.default_rng(chunk + g), g)
    y, st = TM.ssd_chunked(*map(to_torch, ins), chunk=chunk)
    jy, jst = jax.jit(JM.ssd_chunked, static_argnames="chunk")(*map(jnp.asarray, ins), chunk=chunk)
    ny, nst = _naive_ssd(*ins)
    for got, want in ((y, jy), (st, jst)):
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(to_numpy(y), ny, **TOL)
    np.testing.assert_allclose(to_numpy(st), nst, **TOL)
    # a carried-in state: the second half continues the first
    x, dt, A, B, C = ins
    first = (x[:, :16], dt[:, :16], A, B[:, :16], C[:, :16])
    rest = (x[:, 16:], dt[:, 16:], A, B[:, 16:], C[:, 16:])
    _, st1 = TM.ssd_chunked(*map(to_torch, first), chunk=chunk)
    y2, st2 = TM.ssd_chunked(*map(to_torch, rest), chunk=chunk, initial_state=st1)
    np.testing.assert_allclose(to_numpy(y2), ny[:, 16:], **TOL)
    np.testing.assert_allclose(to_numpy(st2), nst, **TOL)


def test_ssd_chunked_refuses_a_ragged_sequence_and_keeps_segsum_finite():
    ins = _ssd_inputs(np.random.default_rng(0), 1, s=12)
    with pytest.raises(ValueError, match="not divisible"):
        TM.ssd_chunked(*map(to_torch, ins), chunk=8)
    y, _ = TM.ssd_chunked(*map(to_torch, ins), chunk=16)        # s <= chunk: one chunk
    assert bool(torch.isfinite(y).all())
    seg = TM._segsum(torch.tensor([[-1.0, -2.0, -3.0]]))
    assert float(seg[0, 0, 1]) == float(np.float32(TM.NEG_INF)) and float(seg[0, 2, 0]) == -5.0


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_decode_step(g):
    rng = np.random.default_rng(7 + g)
    b, h, p, n = 3, 4, 8, 16
    state = rng.normal(size=(b, h, p, n)).astype(np.float32)
    x = rng.normal(size=(b, h, p)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, size=(b, h)).astype(np.float32)
    A = -rng.uniform(0.5, 2, size=(h,)).astype(np.float32)
    B = rng.normal(size=(b, g, n)).astype(np.float32)
    C = rng.normal(size=(b, g, n)).astype(np.float32)
    ins = (state, x, dt, A, B, C)
    y, st = TM.ssd_decode_step(*map(to_torch, ins))
    jy, jst = JM.ssd_decode_step(*map(jnp.asarray, ins))
    np.testing.assert_allclose(to_numpy(y), np.asarray(jy), **TOL)
    np.testing.assert_allclose(to_numpy(st), np.asarray(jst), **TOL)


def test_causal_conv_with_and_without_state():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 12, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    bias = rng.normal(size=(6,)).astype(np.float32)
    y, st = TM._causal_conv(to_torch(x), to_torch(w), to_torch(bias))
    jy, jst = JM._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    np.testing.assert_allclose(to_numpy(y), np.asarray(jy), **TOL)
    np.testing.assert_array_equal(to_numpy(st), np.asarray(jst))
    y1, st1 = TM._causal_conv(to_torch(x[:, :7]), to_torch(w), to_torch(bias))
    y2, st2 = TM._causal_conv(to_torch(x[:, 7:]), to_torch(w), to_torch(bias), state=st1)
    jy2, jst2 = JM._causal_conv(jnp.asarray(x[:, 7:]), jnp.asarray(w), jnp.asarray(bias),
                                state=jnp.asarray(to_numpy(st1)))
    np.testing.assert_allclose(to_numpy(y2), np.asarray(jy2), **TOL)
    np.testing.assert_allclose(to_numpy(torch.cat([y1, y2], 1)), np.asarray(jy), **TOL)
    np.testing.assert_array_equal(to_numpy(st2), np.asarray(jst2))


def test_gated_rmsnorm():
    rng = np.random.default_rng(4)
    x, z = (rng.normal(size=(2, 5, 32)).astype(np.float32) for _ in range(2))
    scale = (1 + 0.3 * rng.normal(size=(32,))).astype(np.float32)
    got = layers.gated_rmsnorm(to_torch(scale), to_torch(x), to_torch(z), 1e-5)
    want = jax_layers.gated_rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                                    jnp.asarray(z), 1e-5)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **TOL)


def _block(g: int, dtype: str):
    """(JAX cfg, port cfg, JAX params, port MambaBlock) with the same
    weights: the JAX init with the norm scale and biases moved off 1 / 0."""
    kw = dict(name="m", family="ssm", n_layers=2, d_model=32, n_heads=0, n_kv_heads=0,
              d_ff=0, vocab_size=64, param_dtype=dtype, compute_dtype=dtype)
    ssm = dict(state_dim=8, head_dim=8, chunk_size=8, n_groups=g)
    jcfg = JaxModelConfig(**kw, ssm=JaxSSMConfig(**ssm))
    tcfg = ModelConfig(**kw, ssm=SSMConfig(**ssm))
    params = JM.init_mamba_block(jcfg, jax.random.key(g))
    rng = np.random.default_rng(g)
    for name in ("conv_x_b", "conv_B_b", "conv_C_b"):
        params[name] = jnp.asarray(0.1 * rng.normal(size=params[name].shape), params[name].dtype)
    params["norm"] = {"scale": jnp.asarray(1 + 0.3 * rng.normal(size=(64,)),
                                           params["norm"]["scale"].dtype)}
    tree = jax.tree.map(np.asarray, params)
    state = {k: _tensor(v) for k, v in tree.items() if k != "norm"}
    state["norm"] = _tensor(tree["norm"]["scale"])
    blk = TM.MambaBlock(tcfg, torch.device("cpu"))
    blk.load_state_dict(state)
    return jcfg, tcfg, params, blk


@pytest.mark.parametrize("g", [1, 2])
def test_block_return_state_then_decode_continues_the_full_sequence(g):
    """`apply_mamba_block(return_state=True)` over 16 tokens, then 8
    `decode_mamba_block` steps, against the JAX block over all 24 and the
    same stitching in JAX; the states too."""
    jcfg, tcfg, params, blk = _block(g, "float32")
    x = np.random.default_rng(11).normal(size=(2, 24, 32)).astype(np.float32)
    full = j_apply(jcfg, params, jnp.asarray(x))
    got_full = TM.apply_mamba_block(tcfg, blk, to_torch(x))
    np.testing.assert_allclose(to_numpy(got_full), np.asarray(full), **TOL)
    y1, st = TM.apply_mamba_block(tcfg, blk, to_torch(x[:, :16]), return_state=True)
    jy1, jst = j_apply(jcfg, params, jnp.asarray(x[:, :16]), return_state=True)
    for a, b in zip(st, jst):
        np.testing.assert_allclose(to_numpy(a), np.asarray(b), **TOL)
    outs = [y1]
    for t in range(16, 24):
        y_t, st = TM.decode_mamba_block(tcfg, blk, to_torch(x[:, t:t + 1]), st)
        jy_t, jst = j_decode(jcfg, params, jnp.asarray(x[:, t:t + 1]), jst)
        np.testing.assert_allclose(to_numpy(y_t), np.asarray(jy_t), **TOL)
        outs.append(y_t)
    np.testing.assert_allclose(to_numpy(torch.cat(outs, 1)), np.asarray(full),
                               rtol=3e-3, atol=3e-4)
    for a, b in zip(st, jst):
        np.testing.assert_allclose(to_numpy(a), np.asarray(b), **TOL)
    # the states keep the reference's dtypes: SSM fp32, conv the compute dtype
    zero = TM.init_mamba_state(tcfg, 2)
    jzero = JM.init_mamba_state(jcfg, 2)
    assert [tuple(a.shape) for a in zero] == [a.shape for a in jzero]


def test_block_bf16():
    """bf16 params and compute: the full-sequence block and one decode step
    within 2e-2 of the output's largest magnitude."""
    jcfg, tcfg, params, blk = _block(2, "bfloat16")
    x = np.random.default_rng(12).normal(size=(2, 16, 32)).astype(np.float32)
    xb = to_torch(x).to(torch.bfloat16)
    got, st = TM.apply_mamba_block(tcfg, blk, xb, return_state=True)
    want, jst = j_apply(jcfg, params, jnp.asarray(x, jnp.bfloat16),
                                     return_state=True)
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == torch.bfloat16 and st.ssm.dtype == torch.float32
    assert st.conv_x.dtype == torch.bfloat16
    np.testing.assert_allclose(to_numpy(got.float()), want, atol=2e-2 * np.abs(want).max())
    y, _ = TM.decode_mamba_block(tcfg, blk, xb[:, :1], st)
    jy, _ = j_decode(jcfg, params, jnp.asarray(x[:, :1], jnp.bfloat16), jst)
    jy = np.asarray(jy.astype(jnp.float32))
    np.testing.assert_allclose(to_numpy(y.float()), jy, atol=2e-2 * np.abs(jy).max())


def test_block_init_matches_the_reference_distributions():
    """`MambaBlock.init`: the JAX init's deterministic leaves exactly,
    conv_C_w == conv_B_w, dt in [dt_min, dt_max], stds of the normals."""
    jcfg, tcfg, params, _ = _block(1, "float32")
    cfg = dataclasses.replace(tcfg, d_model=256)
    blk = TM.MambaBlock(cfg, torch.device("cpu"))
    blk.init(cfg, torch.Generator().manual_seed(0))
    jp = JM.init_mamba_block(dataclasses.replace(jcfg, d_model=256), jax.random.key(0))
    for name in ("A_log", "D", "conv_x_b"):
        np.testing.assert_allclose(to_numpy(getattr(blk, name)), np.asarray(jp[name]),
                                   rtol=1e-6)
    assert torch.equal(blk.conv_C_w, blk.conv_B_w)
    dt0 = torch.nn.functional.softplus(blk.dt_bias)
    assert float(dt0.min()) >= 1e-3 * 0.999 and float(dt0.max()) <= 0.1 * 1.001
    di = cfg.ssm.d_inner(256)
    for w, std in ((blk.in_x, 256**-0.5), (blk.conv_x_w, 0.2),
                   (blk.out_proj, di**-0.5 / (2 * cfg.n_layers) ** 0.5)):
        assert float(w.std()) == pytest.approx(std, rel=0.05)
