"""Port vs JAX at smoke size in fp32, with the same weights: the model
features no smoke config has, on phi4-mini's smoke shape — LayerNorm,
GELU, q/k/v biases, an untied head, soft-capped logits, query heads
padded 6 -> 8 over 2 KV heads and no rotary positions (`rope_style
"none"`) — as units and through the converter,
`prefill` + 3 `decode_step`s and `paged_step` (gather path and K3's plain
version against the JAX gather path)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_families import TOL, check_convert, check_paged, check_prefill_decode  # noqa: E402
from _torch_parity import smoke_configs, to_numpy, to_torch  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

NAME = "gelu-layernorm-bias-untied-softcap-padded"


def test_convert_places_every_leaf():
    check_convert(NAME)


def test_prefill_and_decode_match():
    check_prefill_decode(NAME)


@pytest.mark.parametrize("paged_kernel", [False, True], ids=["gather", "k3_plain"])
def test_paged_step_matches_jax_gather(paged_kernel):
    check_paged(NAME, paged_kernel)


def test_units_layernorm_gelu_untied_softcap():
    jcfg, tcfg = smoke_configs(norm="layernorm", mlp="gelu", tie_embeddings=False,
                               logit_softcap=2.5)
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 5, tcfg.d_model)) * 3 + 1).astype(np.float32)
    scale = rng.normal(size=(tcfg.d_model,)).astype(np.float32)
    np.testing.assert_allclose(
        to_numpy(tl.apply_norm(tcfg, to_torch(scale), to_torch(x))),
        np.asarray(jl.apply_norm(jcfg, {"scale": jnp.asarray(scale)}, jnp.asarray(x))),
        atol=1e-5, rtol=1e-5)
    w_up = (rng.normal(size=(tcfg.d_model, tcfg.d_ff)) * 0.3).astype(np.float32)
    w_down = (rng.normal(size=(tcfg.d_ff, tcfg.d_model)) * 0.1).astype(np.float32)
    np.testing.assert_allclose(
        to_numpy(tl.apply_mlp(tcfg, None, to_torch(w_up), to_torch(w_down), to_torch(x))),
        np.asarray(jl.apply_mlp(jcfg, {"w_up": jnp.asarray(w_up), "w_down": jnp.asarray(w_down)},
                                jnp.asarray(x))), **TOL)
    vp = tcfg.padded_vocab_size
    embed = rng.normal(size=(vp, tcfg.d_model)).astype(np.float32)
    head = rng.normal(size=(tcfg.d_model, vp)).astype(np.float32)
    got = to_numpy(tl.logits_from_hidden(tcfg, to_torch(embed), to_torch(x), to_torch(head)))
    want = np.asarray(jl.logits_from_hidden(
        jcfg, {"embed": jnp.asarray(embed), "lm_head": jnp.asarray(head)}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(got).max() <= 2.5    # the soft cap binds: raw logits reach ~30
