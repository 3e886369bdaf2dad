"""The port's serve and prefill steps across 4 ranks against the
reference's own sharded program for phi3.5-moe at (1, 4) (MoE needs a
data axis of 1; its lengths include one, 6 of 16, that ends inside a
middle rank's slice):
`repro.launch.steps.lower_cell` on a mesh of Auto axes over 4 host
devices (a subprocess with `--xla_force_host_platform_device_count=4`)
and the port's steps on 4 spawned gloo ranks (`tests/_torch_dist.py`)
over `make_local_mesh`, from the same converted weights and inputs, both
at once (`_torch_steps.reference_and_ranks`; one arch a file, to keep
each file short). fp32 tokens identical, a row at capacity included."""
import pytest

from _torch_steps import check_reference_4_devices, reference_and_ranks

CASES = [("phi3.5-moe-42b-a6.6b", (1, 4))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return reference_and_ranks(tmp_path_factory.mktemp("steps_mesh"), CASES)


@pytest.mark.parametrize("case", range(len(CASES)), ids=[a for a, _ in CASES])
def test_tokens_equal_the_reference_4_devices(runs, case):
    check_reference_4_devices(runs, case)
