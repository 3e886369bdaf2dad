"""`build_train_step` against the JAX train step (`make_local_mesh()` +
`repro.launch.steps.build_train_step`, jitted) from the same converted
fp32 weights over the same batches, for the dense family at grad_accum
1 and 2 (one file per family, test_torch_train_<family>.py, so each
stays short: the JAX step compiles once per arch and accum).

Tolerances (ROADMAP T42): the first step sees the same weights, so its
loss is held within 1e-5 and its grad norm within 2e-5 relative; later
steps see weights that differ by rounding (1e-4 and 1e-3). The params
after 3 steps are held within 2e-3 absolute at lr 1e-2: Adam's step is
about +-lr for any nonzero gradient, so an element whose gradient is
rounding noise may step the other way in one package."""
import numpy as np
import pytest

from _torch_train import FAMILY_ARCHS, one_torch_thread, run_steps  # noqa: F401


def check_steps(family: str, accum: int) -> None:
    jms, tms, want, tm = run_steps(FAMILY_ARCHS[family], accum)
    for i, (j, t) in enumerate(zip(jms, tms)):
        tol_loss, tol_norm = (1e-5, 2e-5) if i == 0 else (1e-4, 1e-3)
        assert abs(t["loss"] - j["loss"]) <= tol_loss * abs(j["loss"]), (i, j, t)
        assert abs(t["grad_norm"] - j["grad_norm"]) <= tol_norm * j["grad_norm"], (i, j, t)
        assert abs(t["lr"] - j["lr"]) <= 1e-6 * j["lr"]
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=2e-3, err_msg=k)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_tracks_jax(accum):
    check_steps("dense", accum)
