"""`build_train_step` against the JAX train step for the VLM (qwen2-vl, with M-RoPE positions (3, B, S), split on dim 1 at accum 2)
family at grad_accum 1 and 2, with the tolerances of test_torch_train.py."""
import pytest

from _torch_train import one_torch_thread  # noqa: F401
from test_torch_train import check_steps


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_tracks_jax(accum):
    check_steps("vlm", accum)
