"""FSDP in the train step for the hybrid family (the cases and checks of
test_torch_fsdp_train.py, `_torch_fsdp_train`): zamba2 under full remat
(the recompute gathers again, and T63's `tp_copy` of the whole B / C /
dt weights acts on the gathered ones), at (data, model) = (2, 2) and
(4, 1)."""
import pytest

from _torch_fsdp_train import (MESH_IDS, MESHES, check_gathers, check_streamed_init,
                               check_tracks_world_size_1, check_world_size_1, runs)

NAMES = ["zamba2-full-remat"]


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
    """At (4, 1) Mamba2's projections and the shared block's weights are
    cut over `data`; norm scales and the B / C convs are not."""
    fsdp = set(runs[(4, 1)][0][NAMES[0]]["fsdp"])
    assert {"blocks.0.mamba.in_x", "blocks.0.mamba.in_B", "blocks.0.mamba.out_proj",
            "shared.wq"} <= fsdp
    assert not {n for n in fsdp if "norm" in n or "conv_B" in n}
