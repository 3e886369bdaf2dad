"""The inference placement of FSDP (`inference_param_shardings`) as
data, each weight's resident shard against the reference's local shard
(the cases and the check of test_torch_fsdp_specs.py, `_torch_fsdp`)."""
import pytest

from _torch_fsdp import MESH_IDS, MESHES, SIZES, check
from repro.configs import all_archs


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", all_archs())
def test_inference_shards_are_the_reference_shards(arch, shape):
    for size in SIZES:
        check(arch, size, shape, "serve")


def test_inference_fsdp_only_where_the_reference_keeps_it():
    """At (16, 16) the serve placement cuts over `data` exactly for MoE,
    hybrid and the models over 8 GiB a device after the `model` split."""
    shape = {"data": 16, "model": 16}
    cut = {arch: check(arch, "published", shape, "serve") > 0 for arch in all_archs()}
    assert {a for a, c in cut.items() if c} == {
        "arctic-480b", "phi3.5-moe-42b-a6.6b", "zamba2-2.7b", "command-r-plus-104b",
        "qwen2-vl-72b"}
