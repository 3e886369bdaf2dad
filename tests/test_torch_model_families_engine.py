"""Port vs JAX: `ContinuousBatchingEngine` in manual mode on the MoE
(phi3.5-moe) smoke model in fp32 with the same (converted) weights. One
scripted workload — staggered admission, mixed prompt lengths and
`max_new_tokens`, repeated retrieved-context prefixes — runs through the
JAX engine and the port's engine in the same memory model and schedule:
paged gather and paged fused (K3's plain version; the JAX side runs its
gather path) against the JAX paged engine, fixed-slot against the JAX
fixed-slot engine. Tokens
and `stats()` must be identical. A MoE model's paged and fixed-slot
engines are not held equal to each other: their calls route different
row counts (capacity counts every row, inactive lanes included). The
command-r engines and the CLI entry points of every new architecture are
in `test_torch_model_families_serve.py`."""
import pytest

torch = pytest.importorskip("torch")

from _torch_families import check_engine  # noqa: E402


@pytest.mark.parametrize("mode", ["fixed_slot", "paged_gather", "paged_fused_plain"])
def test_engine_matches_jax(mode):
    check_engine("phi3.5-moe-42b-a6.6b", mode)
