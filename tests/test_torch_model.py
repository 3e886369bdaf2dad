"""Port vs JAX: the dense decoder with the same weights (the JAX init
converted across), at fp32. Logits and caches agree within 1e-4 (the two
packages sum in different orders); greedy tokens are identical."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_parity import converted_models, smoke_configs, to_numpy, to_torch  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro.models import rope as jrope  # noqa: E402
from repro.serving.engine import GenerationEngine as JaxEngine  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import rope as trope  # noqa: E402
from repro_torch.serving.engine import GenerationEngine  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def models():
    return converted_models(seed=0)


def _prompts(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


def test_units_rmsnorm_rope_swiglu():
    jcfg, tcfg = smoke_configs()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, tcfg.d_model)).astype(np.float32)
    scale = rng.normal(size=(tcfg.d_model,)).astype(np.float32)
    np.testing.assert_allclose(
        to_numpy(tl.apply_norm(tcfg, to_torch(scale), to_torch(x))),
        np.asarray(jl.apply_norm(jcfg, {"scale": jnp.asarray(scale)}, jnp.asarray(x))),
        atol=1e-6, rtol=1e-6)
    hd = tcfg.resolved_head_dim
    pos = np.array([[0, 1, 2, 7, 300]] * 2, np.int32)
    xr = rng.normal(size=(2, 5, 3, hd)).astype(np.float32)
    ja = jrope.rope_angles(jnp.asarray(pos), hd, tcfg.rope_theta)
    ta = trope.rope_angles(to_torch(pos), hd, tcfg.rope_theta)
    np.testing.assert_allclose(to_numpy(ta), np.asarray(ja), rtol=1e-6)
    np.testing.assert_allclose(to_numpy(trope.apply_rotary(to_torch(xr), ta)),
                               np.asarray(jrope.apply_rotary(jnp.asarray(xr), ja)),
                               atol=1e-5, rtol=1e-5)
    w = {k: rng.normal(size=s).astype(np.float32) * 0.1 for k, s in
         (("w_gate", (tcfg.d_model, tcfg.d_ff)), ("w_up", (tcfg.d_model, tcfg.d_ff)),
          ("w_down", (tcfg.d_ff, tcfg.d_model)))}
    np.testing.assert_allclose(
        to_numpy(tl.apply_mlp(tcfg, *(to_torch(w[k]) for k in ("w_gate", "w_up", "w_down")),
                              to_torch(x))),
        np.asarray(jl.apply_mlp(jcfg, {k: jnp.asarray(v) for k, v in w.items()},
                                jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("s", [9, 37])
def test_prefill_and_decode_match(models, s):
    """s=37 is not a multiple of the smoke attn_chunk (16): the chunked
    attention pads and masks in both packages."""
    jmodel, params, tmodel = models
    vocab = tmodel.cfg.vocab_size
    toks = _prompts(2, s, vocab, seed=s)
    cache_len = s + 4
    jlog, jc = jmodel.prefill(params, tokens=jnp.asarray(toks), cache_len=cache_len)
    tlog, tc = tmodel.prefill(to_torch(toks).long(), cache_len=cache_len)
    np.testing.assert_allclose(to_numpy(tlog), np.asarray(jlog), **TOL)
    np.testing.assert_allclose(to_numpy(tc.k), np.asarray(jc.k), **TOL)
    np.testing.assert_allclose(to_numpy(tc.v), np.asarray(jc.v), **TOL)
    np.testing.assert_array_equal(to_numpy(tc.length), np.asarray(jc.length))
    nxt = np.array([[3], [vocab - 1]], np.int32)
    for _ in range(3):
        jlog, jc = jmodel.decode_step(params, jc, jnp.asarray(nxt))
        tlog, tc = tmodel.decode_step(tc, to_torch(nxt).long())
        np.testing.assert_allclose(to_numpy(tlog), np.asarray(jlog), **TOL)
        nxt = np.asarray(jnp.argmax(jlog, -1))[:, None].astype(np.int32)
    np.testing.assert_allclose(to_numpy(tc.k), np.asarray(jc.k), **TOL)
    np.testing.assert_array_equal(to_numpy(tc.length), np.asarray(jc.length))


def test_padded_vocab_slots_masked():
    """vocab 500 pads to 512: slots 500.. carry -1e30 in both packages."""
    jmodel, params, tmodel = converted_models(seed=1, vocab_size=500)
    toks = _prompts(1, 6, 500)
    jlog, _ = jmodel.prefill(params, tokens=jnp.asarray(toks))
    tlog, _ = tmodel.prefill(to_torch(toks).long())
    assert tlog.shape == (1, 512)
    assert bool((tlog[:, 500:] == -1e30).all())
    np.testing.assert_array_equal(np.asarray(jlog)[:, 500:], to_numpy(tlog)[:, 500:])
    np.testing.assert_allclose(to_numpy(tlog)[:, :500], np.asarray(jlog)[:, :500], **TOL)


@pytest.mark.parametrize("seed", [0, 3])
def test_greedy_generate_identical(seed):
    jmodel, params, tmodel = converted_models(seed=seed)
    vocab = tmodel.cfg.vocab_size
    toks = _prompts(3, 11, vocab, seed=seed + 10)
    want = JaxEngine(jmodel, params).generate(jnp.asarray(toks), max_new_tokens=10)
    engine = GenerationEngine(tmodel, device="cpu")
    got = engine.generate(toks, max_new_tokens=10)
    assert got.dtype == np.int32 and got.shape == (3, 10)
    np.testing.assert_array_equal(got, want)
    # EOS freezing: take a token some row really emits as eos_id
    eos = int(want[1, 3])
    want_e = JaxEngine(jmodel, params).generate(jnp.asarray(toks), max_new_tokens=10,
                                                eos_id=eos)
    got_e = engine.generate(toks, max_new_tokens=10, eos_id=eos)
    np.testing.assert_array_equal(got_e, want_e)
    assert (got_e[1, 3:] == eos).all()


def test_temperature_sampling_uses_generator(models):
    _, _, tmodel = models
    toks = _prompts(2, 7, tmodel.cfg.vocab_size)
    engine = GenerationEngine(tmodel, temperature=1.0, device="cpu")
    a = engine.generate(toks, 6, generator=torch.Generator().manual_seed(1))
    b = engine.generate(toks, 6, generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(a, b)
    assert ((a >= 0) & (a < tmodel.cfg.vocab_size)).all()


def test_init_draws_at_jax_stds():
    """The port's own init (the card has no JAX): same stds as the JAX
    initializer, within sampling error."""
    _, tcfg = smoke_configs()
    cfg = dataclasses.replace(tcfg, n_layers=4)
    m = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    d, f, hd, L = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim, cfg.n_layers
    blk = m.blocks[0]
    for w, std in ((m.embed, 0.02), (blk.wq, d**-0.5), (blk.mlp.w_gate, d**-0.5),
                   (blk.wo, (cfg.n_heads * hd) ** -0.5 / (2 * L) ** 0.5),
                   (blk.mlp.w_down, f**-0.5 / (2 * L) ** 0.5)):
        assert float(w.std()) == pytest.approx(std, rel=0.05)
    assert bool((blk.attn_norm == 1).all()) and bool((m.final_norm == 1).all())
    assert m.embed.shape == (cfg.padded_vocab_size, d)


def test_unported_families_and_missing_cuda_raise(monkeypatch):
    """The ssm, hybrid and audio families, refused before, build their own
    model: one greedy step from zero caches gives the JAX model's logits
    with converted weights. An unknown family raises, and so does an
    entry point without CUDA."""
    import jax

    from repro_torch.models import EncDecLM, HybridLM, MambaLM

    for arch, cls in (("mamba2-2.7b", MambaLM), ("zamba2-2.7b", HybridLM),
                      ("whisper-small", EncDecLM)):
        jmodel, params, tmodel = converted_models(seed=0, arch=arch)
        assert type(tmodel) is cls and tmodel.cfg.name == f"{arch}-smoke"
        tok = np.array([[5], [7]], np.int32)
        want, _ = jax.jit(jmodel.decode_step)(params, jmodel.init_caches(2, 4, 0),
                                              jnp.asarray(tok))
        got, _ = tmodel.decode_step(tmodel.init_caches(2, 4, 0), to_torch(tok).long())
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=1e-4, rtol=1e-4)
    _, tcfg = smoke_configs()
    with pytest.raises(ValueError, match="unknown family"):
        build_model(dataclasses.replace(tcfg, family="diffusion"), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(tcfg)
    m = build_model(tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        GenerationEngine(m)
