"""The port's losses against the JAX package's `value_and_grad`:
`cross_entropy_loss`, the fused head loss `lm_head_loss` (tied and untied
heads, a padded vocab, labels < 0, soft-capping; fp32 within 1e-5, bf16
within 2e-2), and the DecoderLM families' `loss` and gradients on the
same converted weights (the other families and remat:
test_torch_loss_families.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import smoke_configs, to_numpy
from _torch_train import (FAMILY_ARCHS, assert_grads_close, batch_np, fresh_port_model,  # noqa: F401
                          grads_pair, one_torch_thread)
from repro.models import layers as jax_layers
from repro_torch.models import layers

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _close(got, want, dtype, what):
    got, want = to_numpy(got).astype(np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= TOL[dtype] * scale, (what, err, scale)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_loss(masked):
    """fp32 logits, as `logits_from_hidden` gives them in every compute
    dtype (bf16 heads are held through `test_lm_head_loss`)."""
    dtype = "float32"
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    labels[1, 2:5] = -1
    mask = rng.random((3, 7)) > 0.3 if masked else None
    jdt = jnp.dtype(dtype)

    def jloss(lg):
        return jax_layers.cross_entropy_loss(lg, jnp.asarray(labels),
                                             None if mask is None else jnp.asarray(mask))
    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(logits, jdt))
    t = torch.tensor(logits).to(getattr(torch, dtype)).requires_grad_(True)
    tl = layers.cross_entropy_loss(t, torch.from_numpy(labels).long(),
                                   None if mask is None else torch.from_numpy(mask))
    (tg,) = torch.autograd.grad(tl, t)
    _close(tl.float().detach(), jl, dtype, "loss")
    _close(tg.float(), np.asarray(jg, np.float32), dtype, "dlogits")


def _head_case(dtype, tie, padded, softcap):
    _, tcfg = smoke_configs("phi4-mini-3.8b")
    kw = dict(compute_dtype=dtype, tie_embeddings=tie, logit_softcap=softcap,
              vocab_size=500 if padded else 512)
    tcfg = dataclasses.replace(tcfg, **kw)
    jcfg = dataclasses.replace(smoke_configs("phi4-mini-3.8b")[0], **kw)
    rng = np.random.default_rng(2)
    vp, d = tcfg.padded_vocab_size, tcfg.d_model
    emb = {"embed": rng.normal(size=(vp, d)).astype(np.float32) * 0.3}
    if not tie:
        emb["lm_head"] = rng.normal(size=(d, vp)).astype(np.float32) * 0.1
    hidden = rng.normal(size=(2, 9, d)).astype(np.float32)
    labels = rng.integers(0, tcfg.vocab_size, size=(2, 9)).astype(np.int32)
    labels[0, :4] = -1
    return jcfg, tcfg, emb, hidden, labels


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tie,padded,softcap", [(True, False, 0.0), (True, True, 0.0),
                                                (False, True, 0.0), (False, False, 30.0),
                                                (True, True, 5.0)])
def test_lm_head_loss(dtype, tie, padded, softcap):
    """Loss and the gradients of the hidden states and the head weights."""
    jcfg, tcfg, emb, hidden, labels = _head_case(dtype, tie, padded, softcap)

    def jloss(e, h):
        return jax_layers.lm_head_loss(jcfg, e, h, jnp.asarray(labels))
    jl, (jge, jgh) = jax.value_and_grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in emb.items()}, jnp.asarray(hidden))
    te = {k: torch.tensor(v, requires_grad=True) for k, v in emb.items()}
    th = torch.tensor(hidden, requires_grad=True)
    tl = layers.lm_head_loss(tcfg, te["embed"], th, torch.from_numpy(labels).long(),
                             te.get("lm_head"))
    grads = torch.autograd.grad(tl, [th, *te.values()], allow_unused=True,
                                materialize_grads=True)
    _close(tl.detach(), jl, dtype, "loss")
    _close(grads[0], jgh, dtype, "dhidden")
    for g, k in zip(grads[1:], te):
        _close(g, jge[k], dtype, k)


def test_fused_head_equals_explicit_logits():
    """The fused loss equals cross_entropy_loss over the explicit fp32
    logits (fp32 compute): loss and gradients."""
    _, tcfg, emb, hidden, labels = _head_case("float32", True, True, 0.0)
    lab = torch.from_numpy(labels).long()

    def run(fused):
        e = torch.tensor(emb["embed"], requires_grad=True)
        h = torch.tensor(hidden, requires_grad=True)
        loss = (layers.lm_head_loss(tcfg, e, h, lab) if fused else
                layers.cross_entropy_loss(layers.logits_from_hidden(tcfg, e, h), lab))
        return [loss.detach(), *torch.autograd.grad(loss, [h, e])]
    for a, b in zip(run(True), run(False)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("family", ["dense", "moe", "vlm", "untied"])
def test_family_loss_and_grads(family):
    """`model.loss` and its gradients against JAX's value_and_grad on the
    same converted fp32 weights (the MoE aux losses included)."""
    arch = FAMILY_ARCHS[family]
    cfg = fresh_port_model(arch).cfg
    jl, jg, tl, tg = grads_pair(arch, batch_np(cfg, seed=4))
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    assert_grads_close(jg, tg, 5e-5)
