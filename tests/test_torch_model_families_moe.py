"""Port vs JAX: the sparse-expert `DecoderLM`s at smoke size in fp32, with
the same weights — phi3.5-moe (4 experts, top-2) and Arctic (8 experts
+ the dense residual MLP) — through the converter, `prefill` + 3
`decode_step`s and `paged_step` (gather path and K3's plain version
against the JAX gather path; the decode step's inactive lanes route and
take capacity). `apply_moe` alone is held in `test_torch_moe.py`."""
import pytest

torch = pytest.importorskip("torch")

from _torch_families import check_convert, check_paged, check_prefill_decode  # noqa: E402

NAMES = ["phi3.5-moe-42b-a6.6b", "arctic-480b"]


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
