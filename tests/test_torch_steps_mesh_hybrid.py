"""The port's serve and prefill steps across 4 ranks against the
reference's own sharded program for zamba2 (hybrid: the Mamba2 layers on
each rank's heads and the shared attention block head-parallel over a
sequence-sharded `shared_k` / `shared_v`) at (1, 4) and (2, 2):
`repro.launch.steps.lower_cell` on a mesh of Auto axes over 4 host
devices (a subprocess with `--xla_force_host_platform_device_count=4`)
and the port's steps on 4 spawned gloo ranks (`tests/_torch_dist.py`)
over `make_local_mesh`, from the same converted weights and inputs, both
at once (`_torch_steps.reference_and_ranks`; one arch a file, to keep
each file short). fp32 tokens identical, a row at capacity included."""
import pytest

from _torch_steps import check_reference_4_devices, reference_and_ranks

CASES = [("zamba2-2.7b", (1, 4)), ("zamba2-2.7b", (2, 2))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return reference_and_ranks(tmp_path_factory.mktemp("steps_mesh"), CASES)


@pytest.mark.parametrize("case", range(len(CASES)), ids=[f"{a}-{m}" for a, m in CASES])
def test_tokens_equal_the_reference_4_devices(runs, case):
    check_reference_4_devices(runs, case)
