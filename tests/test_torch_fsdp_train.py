"""FSDP in the train step on spawned gloo ranks (`_torch_dist.tp_train`,
the checks of `_torch_fsdp_train`) against world size 1, at (data,
model) = (2, 2) and (4, 1), for a dense model (phi4-mini, tied head) and
a MoE one whose aux loss weighs heavily (`moe-aux`: the router and the
experts' d cut over `data`, T66's row sums beside the gathers), fp32, 3
steps at lr 1e-2, at ROADMAP T42's tolerances (`_torch_tp.check_close`).
Each rank holds its data slice of every weight the rules cut over
`data`, its gradients reach the state reduce-scattered, and the step
issues the per-layer gathers and reduce-scatters; the seeded init
streams into those shards (T59). World size 1 is the mesh-less step bit
for bit, with no collective. test_torch_fsdp_train_{hybrid,audio}.py
run zamba2 and whisper."""
import pytest

from _torch_fsdp_train import (MESH_IDS, MESHES, check_gathers, check_streamed_init,
                               check_tracks_world_size_1, check_world_size_1, runs)

NAMES = ['phi4-mini-3.8b', 'moe-aux']


@pytest.fixture(scope="module", name="runs")
def _runs(tmp_path_factory):
    return runs(tmp_path_factory.mktemp("fsdp_train"), NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_world_size_1_is_the_mesh_less_step(runs, name):
    check_world_size_1(runs, name)


@pytest.mark.parametrize("shape", list(MESHES), ids=MESH_IDS)
@pytest.mark.parametrize("name", NAMES)
def test_fsdp_step_tracks_world_size_1(runs, name, shape):
    check_tracks_world_size_1(runs, name, shape)


@pytest.mark.parametrize("shape", list(MESHES), ids=MESH_IDS)
@pytest.mark.parametrize("name", NAMES)
def test_gathers_and_reduce_scatters_a_step(runs, name, shape):
    check_gathers(runs, name, shape)


@pytest.mark.parametrize("shape", list(MESHES), ids=MESH_IDS)
@pytest.mark.parametrize("name", NAMES)
def test_streamed_init_is_the_whole_init(runs, name, shape):
    check_streamed_init(runs, name, shape)


def test_what_is_cut_over_data(runs):
    """At (4, 1) the dense weights' non-TP dims, the embedding's width,
    the router and the experts' d are cut over `data`; norm scales are
    not."""
    fsdp = {name: set(runs[(4, 1)][0][name]["fsdp"]) for name in NAMES}
    assert {"embed", "blocks.0.wq", "blocks.0.wo", "blocks.0.mlp.w_down"} <= fsdp["phi4-mini-3.8b"]
    assert {"blocks.0.moe.router", "blocks.0.moe.w_gate", "blocks.0.moe.w_down"} <= fsdp["moe-aux"]
    for name in NAMES:
        assert not {n for n in fsdp[name] if "norm" in n}
