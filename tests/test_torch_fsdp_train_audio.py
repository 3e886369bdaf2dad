"""FSDP in the train step for the audio family (the cases and checks of
test_torch_fsdp_train.py, `_torch_fsdp_train`): whisper's encoder,
decoder and cross attention, and `enc_pos_embed` gathered over `data`,
then over `model`, at (data, model) = (2, 2) and (4, 1)."""
import pytest

from _torch_fsdp_train import (MESH_IDS, MESHES, check_gathers, check_streamed_init,
                               check_tracks_world_size_1, check_world_size_1, runs)

NAMES = ["whisper-small"]


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
    """At (4, 1) `enc_pos_embed`, the encoder's and the cross attention's
    weights are cut over `data`; norm scales are not."""
    fsdp = set(runs[(4, 1)][0][NAMES[0]]["fsdp"])
    assert {"enc_pos_embed", "encoder.0.wq", "decoder.0.cross.wk"} <= fsdp
    assert not {n for n in fsdp if "norm" in n}
