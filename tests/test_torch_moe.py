"""Port vs JAX: `models.moe.apply_moe` (router, top-k with normalised
gates, token-major capacity ranks, the (E, C + 1, d) scatter, the
per-expert SwiGLU, the gather-combine, Arctic's dense residual and
`MoEAux`) on the same weights (the JAX `init_moe` converted across) and
inputs. fp32 agrees within 1e-5; bf16 within 2e-2 (two bf16 ulps at the
outputs' magnitude: the packages' bf16 matmuls may round a product
apart). Dropped tokens, exact router ties and padded / inactive rows that
take capacity are held too."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_parity import smoke_configs, to_numpy, to_torch  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.convert import _tensor  # noqa: E402

F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)


_jax_init = jax.jit(jmoe.init_moe, static_argnums=0)


def _setup(arch="phi3.5-moe-42b-a6.6b", seed=0, **overrides):
    """(JAX config, port config, JAX params, port params)."""
    moe_over = overrides.pop("moe", {})
    jcfg, tcfg = smoke_configs(arch, **overrides)
    if moe_over:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe_over))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, **moe_over))
    jp = _jax_init(jcfg, jax.random.key(seed))
    return jcfg, tcfg, jp, _port_params(jp)


def _port_params(jp):
    """The JAX leaves as port tensors (bf16 bit for bit), as `DecoderLM`'s
    `moe` module holds them."""
    leaves = {k: _tensor(v) for k, v in jp.items() if k != "dense_residual"}
    if "dense_residual" in jp:
        leaves["dense_residual"] = SimpleNamespace(
            **{k: _tensor(v) for k, v in jp["dense_residual"].items()})
    return SimpleNamespace(**leaves)


_jax_moe = jax.jit(jmoe.apply_moe, static_argnums=0)


def _run(jcfg, tcfg, jp, tp, x, tol=F32):
    """Both packages on x; asserts outputs and aux agree; returns the aux."""
    jy, jaux = _jax_moe(jcfg, jp, jnp.asarray(x))
    ty, taux = tmoe.apply_moe(tcfg, tp, to_torch(x))
    np.testing.assert_allclose(to_numpy(ty.float()), np.asarray(jy, np.float32), **tol)
    for name in jmoe.MoEAux._fields:
        np.testing.assert_allclose(float(getattr(taux, name)), float(getattr(jaux, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    return taux


def _x(shape, d, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(*shape, d)) * scale).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 8), (1, 32), (8, 1), (1, 1)])
def test_apply_moe_fp32(shape):
    """Prefill-piece, decode-step and single-token shapes: C = 2, 5, 2, 2."""
    jcfg, tcfg, jp, tp = _setup()
    T = shape[0] * shape[1]
    assert tmoe.capacity(T, tcfg) == jmoe._capacity(T, jcfg)
    _run(jcfg, tcfg, jp, tp, _x(shape, tcfg.d_model, seed=T))


def test_dropped_tokens_agree():
    """A tight capacity (cf 0.5) drops tokens: the same ones in both."""
    jcfg, tcfg, jp, tp = _setup(moe=dict(capacity_factor=0.5))
    aux = _run(jcfg, tcfg, jp, tp, _x((2, 16), tcfg.d_model, seed=3))
    assert float(aux.dropped_fraction) > 0.2


def test_default_capacity_drops_at_serving_shapes():
    """At the config's own cf 1.25 a 32-token prefill piece over 4 experts
    has C = 20 for 64 (token, k) pairs: a skewed router drops some."""
    jcfg, tcfg, jp, tp = _setup()
    jp = dict(jp, router=jp["router"].at[:, 0].add(0.5))      # favour expert 0 ...
    x = np.abs(_x((1, 32), tcfg.d_model, seed=4))              # ... for positive inputs
    aux = _run(jcfg, tcfg, jp, _port_params(jp), x)
    assert float(aux.dropped_fraction) > 0


def test_arctic_dense_residual():
    jcfg, tcfg, jp, tp = _setup("arctic-480b")
    assert "dense_residual" in jp
    _run(jcfg, tcfg, jp, tp, _x((2, 8), tcfg.d_model, seed=5))


def test_router_ties_break_to_the_lower_expert():
    """Router columns 1 = 2 = 3: every token's logits tie exactly there;
    `lax.top_k` takes the lower index first, and so must the port (the
    outputs differ if another tied expert is taken: their weights differ)."""
    jcfg, tcfg, jp, tp = _setup()
    r = np.asarray(jp["router"]).copy()
    r[:, 2] = r[:, 1]
    r[:, 3] = r[:, 1]
    r[:, 0] -= 10.0                   # expert 0 never wins: the tie decides both picks
    jp = dict(jp, router=jnp.asarray(r))
    x = np.abs(_x((2, 8), tcfg.d_model, seed=6))
    _run(jcfg, tcfg, jp, _port_params(jp), x)
    probs = torch.softmax(to_torch(x).reshape(-1, tcfg.d_model) @ to_torch(r), dim=-1)
    _, idx = tmoe.route(probs, 2)
    _, jidx = jax.lax.top_k(jnp.asarray(to_numpy(probs)), 2)
    np.testing.assert_array_equal(to_numpy(idx), np.asarray(jidx))
    assert (to_numpy(idx) == [1, 2]).all()


def test_padded_and_inactive_rows_take_capacity():
    """Capacity counts every row of the call: padding rows placed before
    the valid ones (inactive decode lanes in the first slots) rank first
    and push valid tokens out, identically in both packages; placed after
    the valid rows they leave those rows' routing as it was."""
    jcfg, tcfg, jp, tp = _setup(moe=dict(capacity_factor=0.5))
    d = tcfg.d_model
    valid = _x((1, 6), d, seed=7)[0]
    pad = np.repeat(_x((1, 1), d, seed=8)[0], 6, axis=0)   # identical garbage rows
    first = np.concatenate([pad, valid])[:, None]           # (12, 1, d): decode lanes
    last = np.concatenate([valid, pad])[:, None]
    assert float(_run(jcfg, tcfg, jp, tp, first).dropped_fraction) > 0
    _run(jcfg, tcfg, jp, tp, last)
    yf, _ = tmoe.apply_moe(tcfg, tp, to_torch(first))
    yl, _ = tmoe.apply_moe(tcfg, tp, to_torch(last))
    assert not torch.allclose(yf[6:], yl[:6])               # padding first changed them


def test_apply_moe_bf16():
    jcfg, tcfg, jp, tp = _setup(compute_dtype="bfloat16", param_dtype="bfloat16")
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tp = _port_params(jp)
    assert tp.w_gate.dtype == torch.bfloat16
    x = _x((2, 16), tcfg.d_model, seed=9)
    jy, jaux = _jax_moe(jcfg, jp, jnp.asarray(x, jnp.bfloat16))
    ty, taux = tmoe.apply_moe(tcfg, tp, to_torch(x).bfloat16())
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(to_numpy(ty.float()), np.asarray(jy, np.float32), **BF16)
    np.testing.assert_allclose(float(taux.dropped_fraction), float(jaux.dropped_fraction))


def test_router_jitter_refused():
    """A config with router_jitter routes as the JAX `apply_moe` does when
    its caller passes no key (none of its callers does): without jitter."""
    jcfg, tcfg, jp, tp = _setup(moe=dict(router_jitter=0.1))
    _run(jcfg, tcfg, jp, tp, _x((2, 8), tcfg.d_model, seed=11))
