"""The port's optimizers against the JAX package's: `cosine_lr`,
`global_norm`, fp32 AdamW `update` over 3 steps from the same converted
params and gradients, the weight-decay rule (by the JAX leaf's rank),
the 8-bit moment (codes and scales bit-equal, blocks spanning layers),
`quantize_tree`, and the reference's own optimizer cases."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train import jax_model, one_torch_thread  # noqa: F401
from repro.optim import adamw as jax_adamw
from repro.optim import grad_compression as jax_gc
from repro.optim import quant_state as jax_q8
from repro_torch.launch.mesh import distributed, make_local_mesh
from repro_torch.models.convert import jax_leaves, params_from_jax
from repro_torch.optim import adamw, grad_compression, quant_state

CFG = dict(lr=1e-2, warmup_steps=3, total_steps=20)


def _np(t):
    return t.detach().float().numpy()


def _grad_tree(params, seed):
    """Seeded normal gradients shaped like a JAX param tree."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)
                                              * 0.1), params)


def test_cosine_lr_matches_jitted_reference():
    for kw in (CFG, dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1),
               dict(lr=3e-4, warmup_steps=0, total_steps=7)):
        jc, tc = jax_adamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
        steps = np.arange(0, kw["total_steps"] + 5, dtype=np.int32)
        want = np.asarray(jax.jit(jax.vmap(lambda s: jax_adamw.cosine_lr(jc, s)))(steps))
        got = adamw.cosine_lr(tc, torch.from_numpy(steps)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)   # cos: an ulp or two


def test_cosine_schedule_shape():
    """The reference's schedule case."""
    cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    lrs = [float(adamw.cosine_lr(cfg, torch.tensor(s))) for s in [0, 5, 10, 55, 100]]
    assert lrs[0] == 0.0 and lrs[1] == 0.5 and lrs[2] == 1.0
    assert 0.1 < lrs[3] < 1.0
    assert np.isclose(lrs[4], 0.1)


def test_global_norm():
    rng = np.random.default_rng(0)
    leaves = [rng.normal(size=s).astype(np.float32) for s in [(4, 5), (7,), (3, 2, 2)]]
    want = float(jax_adamw.global_norm([jnp.asarray(x) for x in leaves]))
    got = float(adamw.global_norm([torch.from_numpy(x) for x in leaves]))
    assert abs(got - want) <= 1e-6 * want


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "zamba2-2.7b"])
def test_adamw_update_three_steps(arch):
    """Three updates from the same params and gradients: master, moments
    and params allclose, lr and the clip's grad norm equal."""
    _, params, tcfg, state = jax_model(arch)
    jc, tc = jax_adamw.AdamWConfig(**CFG), adamw.AdamWConfig(**CFG)
    decay = adamw.decay_mask(jax_leaves(tcfg))
    tparams = {k: v.clone() for k, v in state.items()}
    jst, tst = jax_adamw.init(params), adamw.init(tparams)
    jup = jax.jit(lambda g, s, p: jax_adamw.update(jc, g, s, p))
    jp = params
    for i in range(3):
        g = _grad_tree(params, seed=i)
        jp, jst, jm = jup(g, jst, jp)
        tg = params_from_jax(jax.tree.map(np.asarray, g), tcfg)
        tparams, tst, tm = adamw.update(tc, tg, tst, tparams, decay)
        assert float(tm["lr"]) == float(jm["lr"])
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-6 * float(jm["grad_norm"])
    assert int(tst.step) == int(jst.step) == 3
    for name, jtree in (("master", jst.master), ("mu", jst.mu), ("nu", jst.nu)):
        want = params_from_jax(jax.tree.map(np.asarray, jtree), tcfg)
        for k, v in getattr(tst, name).items():
            np.testing.assert_allclose(_np(v), _np(want[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{name} {k}")
    want = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    for k, v in tparams.items():
        np.testing.assert_allclose(_np(v), _np(want[k]), rtol=1e-5, atol=1e-7, err_msg=k)


def test_weight_decay_follows_jax_leaf_rank():
    """Decayed: every per-layer leaf (norm scales, Mamba2 A_log / D /
    dt_bias, conv biases), stacked to rank >= 2 in the JAX tree; not
    decayed: final_norm and the hybrid's shared-block norms. With zero
    gradients an update is pure decay, equal to the JAX update's."""
    _, params, tcfg, state = jax_model("zamba2-2.7b")
    decay = adamw.decay_mask(jax_leaves(tcfg))
    assert decay["blocks.0.norm"] and decay["blocks.1.mamba.A_log"]
    assert decay["blocks.0.mamba.D"] and decay["blocks.0.mamba.dt_bias"]
    assert decay["blocks.0.mamba.conv_x_b"] and decay["shared.wq"]
    assert not decay["final_norm"] and not decay["shared.attn_norm"]
    assert not decay["shared.mlp_norm"]
    assert state["blocks.0.norm"].ndim == 1       # (d,) in the port
    cfg = dict(CFG, warmup_steps=0, weight_decay=0.5)
    zeros = jax.tree.map(jnp.zeros_like, params)
    jp, _, _ = jax_adamw.update(jax_adamw.AdamWConfig(**cfg), zeros, jax_adamw.init(params),
                                params)
    tparams = {k: v.clone() for k, v in state.items()}
    tparams, _, _ = adamw.update(adamw.AdamWConfig(**cfg),
                                 {k: torch.zeros_like(v) for k, v in state.items()},
                                 adamw.init(tparams), tparams, decay)
    want = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    for k, v in tparams.items():
        np.testing.assert_array_equal(_np(v), _np(want[k]), err_msg=k)
        assert torch.equal(v, state[k]) == (not decay[k] or not state[k].any()), k


def test_adam8_codes_bit_equal_across_layers():
    """L 2, d 96: a norm-scale leaf is (2, 96) in the JAX tree, so its
    second block of 128 holds 32 entries of layer 0 and 96 of layer 1.
    One jitted JAX update and the port's (no clipping) give bit-equal
    codes, scales and bf16 first moments."""
    _, params, tcfg, state = jax_model("phi4-mini-3.8b")
    assert tcfg.d_model == 96 and tcfg.n_layers == 2
    kw = dict(CFG, grad_clip=0.0)
    leaves = jax_leaves(tcfg)
    groups = {p: leaf.names for p, leaf in leaves.items()}
    decay = adamw.decay_mask(leaves)
    jst = jax_q8.init(params)
    jup = jax.jit(lambda g, s, p: jax_q8.update(jax_adamw.AdamWConfig(**kw), g, s, p))
    tparams = {k: v.clone() for k, v in state.items()}
    tst = quant_state.init(tparams, groups)
    jp = params
    for i in range(2):
        g = _grad_tree(params, seed=10 + i)
        jp, jst, _ = jup(g, jst, jp)
        tparams, tst, _ = quant_state.update(
            adamw.AdamWConfig(**kw), params_from_jax(jax.tree.map(np.asarray, g), tcfg),
            tst, tparams, groups, decay)
        flat = dict(jax.tree_util.tree_flatten_with_path(
            jst.nu, is_leaf=lambda x: isinstance(x, jax_q8.QuantMoment))[0])
        jnu = {"/".join(str(getattr(p, "key", p)) for p in path): q for path, q in flat.items()}
        assert set(jnu) == set(tst.nu)
        for path, q in tst.nu.items():
            if i == 0:   # from the same state: bit-equal
                np.testing.assert_array_equal(q.codes.numpy(), np.asarray(jnu[path].codes),
                                              err_msg=path)
                np.testing.assert_array_equal(q.scales.numpy(), np.asarray(jnu[path].scales),
                                              err_msg=path)
            assert q.size == jnu[path].size
        if i == 0:
            jmu = params_from_jax(jax.tree.map(np.asarray, jst.mu), tcfg)
            for k, v in tst.mu.items():
                assert torch.equal(v, jmu[k]), k
    want = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    for k, v in tparams.items():
        np.testing.assert_allclose(_np(v), _np(want[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    assert leaves["blocks/attn_norm/scale"].ndim == 2
    assert tst.nu["blocks/attn_norm/scale"].codes.shape == (2, 128)


def test_quantize_nonneg_bit_equal():
    """The port's scale is XLA's jitted one (max * f32(1/255)), codes a
    true division."""
    x = np.abs(np.random.default_rng(0).normal(size=(1000,))).astype(np.float32)
    want = jax.jit(jax_q8.quantize_nonneg)(jnp.asarray(x))
    got = quant_state.quantize_nonneg(torch.from_numpy(x))
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    back = quant_state.dequantize_nonneg(got, x.shape).numpy()
    np.testing.assert_array_equal(back, np.asarray(jax_q8.dequantize_nonneg(want, x.shape)))


def test_adam8_matches_fp32_adamw_trajectory():
    """The reference's case: same quadratic, same schedule."""
    target = torch.tensor([1.0, -2.0, 3.0, 0.5] * 64)
    cfg = adamw.AdamWConfig(lr=0.05, warmup_steps=5, total_steps=300, weight_decay=0.0)
    p_ref, p_q = {"w": torch.zeros(256)}, {"w": torch.zeros(256)}
    s_ref, s_q = adamw.init(p_ref), quant_state.init(p_q)
    for _ in range(200):
        p_ref, s_ref, _ = adamw.update(cfg, {"w": 2 * (p_ref["w"] - target)}, s_ref, p_ref)
        p_q, s_q, _ = quant_state.update(cfg, {"w": 2 * (p_q["w"] - target)}, s_q, p_q)
    l_ref = float(((p_ref["w"] - target) ** 2).sum())
    l_q = float(((p_q["w"] - target) ** 2).sum())
    assert l_q < 1e-2, l_q
    assert abs(l_q - l_ref) < 5e-3, (l_ref, l_q)


def test_adamw_converges_and_keeps_bf16_params():
    target = torch.tensor([1.0, -2.0, 3.0])
    p = {"w": torch.zeros(3)}
    cfg = adamw.AdamWConfig(lr=0.1, warmup_steps=5, total_steps=200, weight_decay=0.0)
    st = adamw.init(p)
    for _ in range(150):
        p, st, _ = adamw.update(cfg, {"w": 2 * (p["w"] - target)}, st, p)
    assert float(((p["w"] - target) ** 2).sum()) < 1e-3
    pb = {"w": torch.zeros((4, 4), dtype=torch.bfloat16)}
    st = adamw.init(pb)
    assert st.master["w"].dtype == torch.float32
    pb, st, _ = adamw.update(adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10),
                             {"w": torch.ones((4, 4), dtype=torch.bfloat16)}, st, pb)
    assert pb["w"].dtype == torch.bfloat16 and st.master["w"].dtype == torch.float32
    assert st.master["w"].abs().sum() > 0


def test_memory_accounting():
    assert quant_state.state_bytes_per_param() == jax_q8.state_bytes_per_param()
    assert quant_state.state_bytes_per_param() < 7.1


def test_quantize_tree_matches_jitted_reference(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(8, 8)).astype(np.float32),
            "c": rng.normal(size=(33,)).astype(np.float32) * 1e-3,
            "z": np.zeros((5,), np.float32)}
    jq, js = jax.jit(jax_gc.quantize_tree)({k: jnp.asarray(v) for k, v in tree.items()})
    for t in ({k: torch.from_numpy(v) for k, v in tree.items()},):
        q, s = grad_compression.quantize_tree(t)
        for k in tree:
            np.testing.assert_array_equal(q[k].numpy(), np.asarray(jq[k]), err_msg=k)
            np.testing.assert_array_equal(s[k].numpy(), np.asarray(js[k]), err_msg=k)
        back = grad_compression.dequantize_tree(q, s)
        for k, v in tree.items():
            assert np.abs(back[k].numpy() - v).max() <= float(s[k]) / 2 + 1e-7
    ql, sl = grad_compression.quantize_tree([torch.from_numpy(v) for v in tree.values()])
    assert [x.dtype for x in ql] == [torch.int8] * 3 and len(sl) == 3
    ef = grad_compression.init_error_feedback([torch.ones(3), torch.ones(2, 2)])
    assert all((e == 0).all() and e.dtype == torch.float32 for e in ef)
    # `compressed_psum` over a one-rank mesh: the dequantized codes, and
    # the rounding left as error feedback (more ranks: test_torch_train_mesh.py)
    g = {k: torch.from_numpy(v) for k, v in tree.items()}
    with distributed(0, 1, store_path=str(tmp_path / "store"), device="cpu"):
        out, err = grad_compression.compressed_psum(
            g, grad_compression.init_error_feedback(g), make_local_mesh(device="cpu"))
    q, s = grad_compression.quantize_tree(g)
    for k in tree:
        assert torch.equal(out[k], q[k].float() * s[k])
        assert torch.equal(err[k], g[k] - q[k].float() * s[k])


def test_error_feedback_reduces_bias():
    """The reference's case on the port's `_q`."""
    g_true = torch.from_numpy(np.random.default_rng(0).normal(size=(64,)).astype(np.float32))
    err = torch.zeros_like(g_true)
    acc = torch.zeros(64, dtype=torch.float64)
    for _ in range(50):
        g32 = g_true + err
        q, s = grad_compression._q(g32)
        local = q.float() * s
        err = g32 - local
        acc += local.double()
    np.testing.assert_allclose((acc / 50).numpy(), g_true.numpy(), rtol=1e-2, atol=5e-3)
