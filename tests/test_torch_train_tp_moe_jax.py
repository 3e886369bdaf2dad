"""The port's train step for phi3.5-moe's fp32 smoke model over a data
axis (MoE routing over the global batch) on 4 spawned gloo ranks against
the reference's own sharded train step: `repro.launch.steps.
build_train_step(cfg, mesh)` jitted on a mesh of Auto axes over 4 host
devices at (data, model) = (2, 2) and (4, 1), in a subprocess with
`--xla_force_host_platform_device_count=4` (`_torch_train.
reference_tp_step0`). Both start from the same weights (the JAX init,
converted) and take the same global batch: step 0's loss within 1e-5,
grad norm within 2e-5 (relative, ROADMAP T42) and the parameters after
the update within 2e-3 (`_torch_train.check_step0`). Per-shard routing
misses the loss by 3.8e-5 and 6.0e-4 relative at (2, 2) and (4, 1) on
this batch."""
import pytest

from _torch_train import check_step0, reference_tp_step0

ARCH = "phi3.5-moe-42b-a6.6b"
SHAPES = [(2, 2), (4, 1)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return reference_tp_step0(tmp_path_factory.mktemp("tp_moe_jax"), ARCH, SHAPES)


@pytest.mark.parametrize("i", range(len(SHAPES)), ids=[f"data{d}-model{m}" for d, m in SHAPES])
def test_step_0_matches_the_reference_4_devices(runs, i):
    ref, port = runs
    check_step0(ref, port[SHAPES[i]], ARCH, SHAPES[i])
