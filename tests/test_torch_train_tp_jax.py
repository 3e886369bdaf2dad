"""The port's tensor-parallel train step on 4 spawned gloo ranks against
the reference's own sharded train step: `repro.launch.steps.
build_train_step(cfg, mesh)` (FSDP x TP under GSPMD, parameters and
gradients placed by `param_shardings`), jitted on a mesh of Auto axes
over 4 host devices at (data, model) = (1, 4), (2, 2) and (4, 1), in a
subprocess with `--xla_force_host_platform_device_count=4` (the
reference's own `make_local_mesh` has Explicit axes, on which its steps
fail: ROADMAP §3). Both start from the same weights (the JAX init,
converted) and take the same global batch: step 0's loss within 1e-5
and grad norm within 2e-5 (relative, ROADMAP T42), for phi4-mini's fp32
smoke model; the parameters after the update within 2e-3, whole and as
rank 0's resident shards (FSDP x TP) against the reference's shards on
its first device."""
import pytest

from _torch_train import check_step0, reference_tp_step0

ARCH = "phi4-mini-3.8b"
SHAPES = [(1, 4), (2, 2), (4, 1)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return reference_tp_step0(tmp_path_factory.mktemp("tp_jax"), ARCH, SHAPES)


@pytest.mark.parametrize("i", range(len(SHAPES)), ids=[f"data{d}-model{m}" for d, m in SHAPES])
def test_step_0_matches_the_reference_4_devices(runs, i):
    ref, port = runs
    check_step0(ref, port[SHAPES[i]], ARCH, SHAPES[i])
