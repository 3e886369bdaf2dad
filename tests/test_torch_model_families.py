"""Port vs JAX: the `DecoderLM` families at smoke size in fp32, with the
same weights (the JAX init converted across). This file: the six new
configs against the reference's, full-width shapes on the meta device,
and the dense smoke models phi3-medium (GQA g 1) and granite (MQA)
through the converter, `prefill` + 3 `decode_step`s and `paged_step`
(gather path and K3's plain version against the JAX gather path). The
other models are in `test_torch_model_families_{moe,parallel,vlm,
features}.py` and the engines in `test_torch_model_families_engine.py`:
split by model, so that each file stays short under -n 6."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

from _torch_families import check_convert, check_paged, check_prefill_decode  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import DecoderLM  # noqa: E402

ARCHS = ["phi3-medium-14b", "granite-34b", "command-r-plus-104b",
         "phi3.5-moe-42b-a6.6b", "arctic-480b", "qwen2-vl-72b"]
DENSE = ["phi3-medium-14b", "granite-34b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    """FULL and SMOKE carry the reference's value in every field the port
    has (the port leaves out only training knobs)."""
    for smoke in (False, True):
        t, j = get_config(arch, smoke=smoke), jax_get_config(arch, smoke=smoke)
        for f in dataclasses.fields(t):
            a, b = getattr(t, f.name), getattr(j, f.name)
            if dataclasses.is_dataclass(a):    # MoEConfig: the packages' own types
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, (arch, smoke, f.name)
        assert t.effective_n_heads == j.effective_n_heads
        assert t.padded_vocab_size == j.padded_vocab_size


def test_full_width_shapes_on_meta():
    """Arctic's 56 heads are padded to 64 real ones (wq / wo (7168, 8192) /
    (8192, 7168)); phi3.5-moe's experts are (16, 4096, 6400); command-r's
    parallel block has no second norm."""
    arctic = DecoderLM(get_config("arctic-480b"), device="meta")
    blk = arctic.blocks[0]
    assert tuple(blk.wq.shape) == (7168, 8192) and tuple(blk.wo.shape) == (8192, 7168)
    assert tuple(blk.moe.w_gate.shape) == (128, 7168, 4864)
    assert tuple(blk.moe.dense_residual.w_down.shape) == (4864, 7168)
    moe = DecoderLM(get_config("phi3.5-moe-42b-a6.6b"), device="meta")
    assert tuple(moe.blocks[0].moe.w_up.shape) == (16, 4096, 6400)
    assert tuple(moe.blocks[0].moe.router.shape) == (4096, 16)
    cmdr = DecoderLM(get_config("command-r-plus-104b"), device="meta").blocks[0]
    assert cmdr.mlp_norm is None and cmdr.moe is None


@pytest.mark.parametrize("arch", DENSE)
def test_convert_places_every_leaf(arch):
    check_convert(arch)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match(arch):
    check_prefill_decode(arch)


@pytest.mark.parametrize("paged_kernel", [False, True], ids=["gather", "k3_plain"])
@pytest.mark.parametrize("arch", DENSE)
def test_paged_step_matches_jax_gather(arch, paged_kernel):
    check_paged(arch, paged_kernel)


def test_port_init_at_jax_stds():
    """The port's own init (the card has no JAX) draws every new leaf at
    the JAX initializer's std: router and expert-in d^-0.5, expert-out and
    dense-residual-out f^-0.5/sqrt(2L) with f each MLP's own width,
    attention-out over the padded heads, the untied head d^-0.5; biases 0."""
    cfg = dataclasses.replace(get_config("arctic-480b", smoke=True), n_layers=4,
                              attn_bias=True, tie_embeddings=False, n_heads=3,
                              pad_attn_heads_to=2, moe=dataclasses.replace(
                                  get_config("arctic-480b", smoke=True).moe,
                                  dense_residual_d_ff=48))
    m = DecoderLM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    d, f, L, hd = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.resolved_head_dim
    blk = m.blocks[0]
    assert blk.wq.shape == (d, 4 * hd)          # 3 heads padded to 4
    for w, std in ((blk.moe.router, d**-0.5), (blk.moe.w_gate, d**-0.5),
                   (blk.moe.w_down, f**-0.5 / (2 * L) ** 0.5),
                   (blk.moe.dense_residual.w_up, d**-0.5),
                   (blk.moe.dense_residual.w_down, 48**-0.5 / (2 * L) ** 0.5),
                   (blk.wo, (4 * hd) ** -0.5 / (2 * L) ** 0.5), (m.lm_head, d**-0.5)):
        assert float(w.std()) == pytest.approx(std, rel=0.08)
    assert bool((blk.bq == 0).all()) and bool((blk.bv == 0).all())
    assert bool((blk.mlp_norm == 1).all()) and blk.mlp is None
