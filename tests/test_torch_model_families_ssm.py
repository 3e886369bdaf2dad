"""Port vs JAX: the mamba2 / zamba2 / whisper configs field by field;
`MambaLM` (mamba2-2.7b) and `HybridLM` (zamba2-2.7b) at smoke size in
fp32 with the same (converted) weights — `forward` logits (the chunked
SSD and, for the hybrid, the shared block's chunked attention), 8
`decode_step`s from zero caches (logits each step, every cache leaf
after), `init_caches` shapes and dtypes, and the weight conversion
(`_torch_ssm`)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_numpy, to_torch
from _torch_ssm import ARCHS as ALL_NEW, TOL, check_decode, models, prompts
from repro.configs import get_config as jax_get_config
from repro_torch.configs import get_config
from repro_torch.models import HybridLM, MambaLM, build_model, supports_paged_kv
from repro_torch.models.convert import params_from_jax

ARCHS = ["mamba2-2.7b", "zamba2-2.7b"]
_FWD: dict = {}


def _forward(arch, toks):
    jmodel, params, _, _ = models(arch)
    if arch not in _FWD:
        _FWD[arch] = jax.jit(jmodel.forward)
    return np.asarray(_FWD[arch](params, jnp.asarray(toks))[0])


@pytest.mark.parametrize("arch", ALL_NEW)
def test_configs_match_reference(arch):
    """FULL and SMOKE of mamba2 / zamba2 / whisper carry the reference's
    value in every field the port has, the SSM and encoder sub-configs
    included (the port leaves out only training knobs)."""
    for smoke in (False, True):
        t, j = get_config(arch, smoke=smoke), jax_get_config(arch, smoke=smoke)
        for f in dataclasses.fields(t):
            a, b = getattr(t, f.name), getattr(j, f.name)
            if dataclasses.is_dataclass(a):    # the packages' own sub-config types
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, (arch, smoke, f.name)
        assert t.ssm is None or t.ssm.n_heads(t.d_model) == j.ssm.n_heads(j.d_model)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits(arch):
    """32 tokens: two SSD chunks of the smoke chunk 16 (and, for the
    hybrid, two attention chunks of 16 with RoPE)."""
    tmodel = models(arch)[3]
    assert isinstance(tmodel, MambaLM if arch.startswith("mamba") else HybridLM)
    assert not supports_paged_kv(tmodel)
    toks = prompts(2, 32, tmodel.cfg.vocab_size, seed=4)
    got = tmodel.forward(to_torch(toks).long())
    np.testing.assert_allclose(to_numpy(got), _forward(arch, toks), **TOL)
    # the streamed decode of the same tokens ends at the forward's last logits
    caches = tmodel.init_caches(2, 32, 0)
    for t in range(32):
        last, caches = tmodel.decode_step(caches, to_torch(toks[:, t:t + 1]).long())
    np.testing.assert_allclose(to_numpy(last), to_numpy(got)[:, -1], **TOL)
    assert caches.length.tolist() == [32, 32]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_and_caches(arch):
    check_decode(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trip(arch):
    """Every JAX leaf lands in the port's state dict bit for bit; an extra
    leaf, an empty place and a wrong shape raise."""
    _, params, _, tmodel = models(arch)
    tree = jax.tree.map(np.asarray, params)
    state = params_from_jax(tree, tmodel.cfg)
    assert set(state) == set(tmodel.state_dict())
    for k, v in tmodel.state_dict().items():
        assert torch.equal(state[k], v), k
    with pytest.raises(ValueError, match="no place"):
        params_from_jax(dict(tree, extra={"w": np.zeros(3, np.float32)}), tmodel.cfg)
    mamba = dict(tree["blocks"]["mamba"])
    mamba.pop("D")
    with pytest.raises(ValueError, match="leaves empty"):
        params_from_jax(dict(tree, blocks=dict(tree["blocks"], mamba=mamba)), tmodel.cfg)
    mamba = dict(tree["blocks"]["mamba"], in_z=tree["blocks"]["mamba"]["in_z"][..., :-1])
    with pytest.raises(ValueError, match="in_z: JAX shape"):
        params_from_jax(dict(tree, blocks=dict(tree["blocks"], mamba=mamba)), tmodel.cfg)
    if arch.startswith("zamba"):
        shared = dict(tree["shared"], attn=dict(tree["shared"]["attn"],
                                                wo=tree["shared"]["attn"]["wo"][:-1]))
        with pytest.raises(ValueError, match="shared.wo: JAX shape"):
            params_from_jax(dict(tree, shared=shared), tmodel.cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_distributions_stay_finite_at_depth(arch):
    """The port's own seeded init (the reference's distributions, not its
    draws): 16 layers of random Mamba2 blocks keep the logits finite and
    O(1), and the deterministic leaves equal the JAX init's."""
    _, params, _, tmodel = models(arch)
    cfg = dataclasses.replace(tmodel.cfg, n_layers=16,
                              hybrid_attn_every=tmodel.cfg.hybrid_attn_every and 4)
    m = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    toks = prompts(2, 16, cfg.vocab_size, seed=5)
    logits = m.forward(to_torch(toks).long())[..., :cfg.vocab_size]
    assert bool(torch.isfinite(logits).all()) and float(logits.abs().max()) < 50
    blk = m.blocks[0].mamba
    np.testing.assert_allclose(to_numpy(blk.A_log),
                               np.asarray(params["blocks"]["mamba"]["A_log"][0]), rtol=1e-6)
    assert bool((blk.D == 1).all()) and torch.equal(blk.conv_B_w, blk.conv_C_w)
