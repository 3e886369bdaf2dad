"""The port's serve and prefill steps across 4 ranks against the
reference's own sharded program for whisper (audio: the encoder, the
decoder's self and cross attention head-parallel, the cross K/V's frames
over `model`) at (1, 4) and (2, 2): `repro.launch.steps.lower_cell` on a
mesh of Auto axes over 4 host devices (a subprocess with
`--xla_force_host_platform_device_count=4`) and the port's steps on 4
spawned gloo ranks (`tests/_torch_dist.py`) over `make_local_mesh`, from
the same converted weights and inputs, both at once
(`_torch_steps.reference_and_ranks`; one arch a file, to keep each file
short). fp32 tokens identical, a row at capacity included. At (1, 4) the
24 cross frames go 6 a rank and every head's query is combined across
ranks (T65)."""
import pytest

from _torch_steps import check_reference_4_devices, reference_and_ranks

# whisper-f26's 26 frames do not divide over `model` 4: the cross K/V stay
# whole and each rank's query heads read them (`attention.cross_decode`)
CASES = [("whisper-small", (1, 4)), ("whisper-small", (2, 2)), ("whisper-f26", (1, 4))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return reference_and_ranks(tmp_path_factory.mktemp("steps_mesh"), CASES)


@pytest.mark.parametrize("case", range(len(CASES)), ids=[f"{a}-{m}" for a, m in CASES])
def test_tokens_equal_the_reference_4_devices(runs, case):
    check_reference_4_devices(runs, case)
