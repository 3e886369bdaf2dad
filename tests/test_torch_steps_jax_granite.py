"""The port's production inference steps (`launch.steps.build_cell` on a
one-rank CPU mesh) against the reference's own programs
(`repro.launch.steps.lower_cell` on a (1, 1) mesh of Auto axes) for
granite-34b at smoke size, from the same converted weights and inputs
(`_torch_steps`; one arch a file, test_torch_steps_jax_*.py, since the
reference compiles a program a step and dtype).

At fp32 the tokens are identical and the caches the serve step writes
agree within 1e-5 (as the families' pools do). At bf16 the tokens are
int32 ids in the vocabulary and the logits agree within 2e-2 of the
reference's `decode_step` / `forward` (as `test_torch_moe.py`'s bf16
cases): the steps' programs are those plus an argmax."""
from _torch_steps import check_bf16, check_prefill_fp32, check_serve_fp32, mesh  # noqa: F401

ARCH = "granite-34b"


def test_serve_step_fp32_equals_reference(mesh):  # noqa: F811
    check_serve_fp32(mesh, ARCH)


def test_prefill_step_fp32_equals_reference(mesh):  # noqa: F811
    check_prefill_fp32(mesh, ARCH)


def test_steps_bf16_logits_near_reference(mesh):  # noqa: F811
    check_bf16(mesh, ARCH)
