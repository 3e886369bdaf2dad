"""Port vs JAX at smoke size in fp32, with the same weights: the parallel
blocks — command-r (LayerNorm, x + attn(h) + mlp(h) with h = norm(x))
and Arctic as a parallel block, whose experts and dense residual take the
attention's normed input — through the converter, `prefill` + 3
`decode_step`s and `paged_step` (gather path and K3's plain version
against the JAX gather path)."""
import pytest

torch = pytest.importorskip("torch")

from _torch_families import check_convert, check_paged, check_prefill_decode  # noqa: E402

NAMES = ["command-r-plus-104b", "arctic-parallel"]


@pytest.mark.parametrize("name", NAMES)
def test_convert_places_every_leaf(name):
    check_convert(name)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_match(name):
    check_prefill_decode(name)


@pytest.mark.parametrize("paged_kernel", [False, True], ids=["gather", "k3_plain"])
@pytest.mark.parametrize("name", NAMES)
def test_paged_step_matches_jax_gather(name, paged_kernel):
    check_paged(name, paged_kernel)
