"""Port vs JAX: `ContinuousBatchingEngine` in manual mode on the
parallel-block LayerNorm smoke model (command-r) in fp32 with the same
(converted) weights, each memory model against the JAX engine of the same
mode (`_torch_families.check_engine`, as for phi3.5-moe);
then the serving CLI's generation entry points on every new architecture
at smoke size, on the CPU: `serve --arch` and `build_rag_pipeline(arch=)`."""
import pytest

torch = pytest.importorskip("torch")

from _torch_families import check_engine  # noqa: E402

from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.serving import EngineConfig  # noqa: E402

NEW = ["phi3-medium-14b", "granite-34b", "command-r-plus-104b", "phi3.5-moe-42b-a6.6b",
       "arctic-480b", "qwen2-vl-72b"]


@pytest.mark.parametrize("mode", ["fixed_slot", "paged_gather", "paged_fused_plain"])
def test_engine_matches_jax(mode):
    check_engine("command-r-plus-104b", mode)


@pytest.mark.parametrize("arch", NEW)
def test_serve_entry_points_on_every_new_arch(arch, capsys):
    """`serve --arch <arch> --smoke` and `build_rag_pipeline(arch=)` with a
    `query_stream(generate=True)` through K3's plain version."""
    tserve.main(["--arch", arch, "--device", "cpu", "--batch", "2", "--prompt-len", "4",
                 "--new-tokens", "2"])
    assert "generated (2, 2) tokens" in capsys.readouterr().out
    pipe = tserve.build_rag_pipeline(n_docs=16, n_shards=2, dim=32, arch=arch, device="cpu")
    assert pipe.engine.model.cfg.name.endswith("-smoke")
    items = list(pipe.query_stream(
        [pipe.doc_texts[3], pipe.doc_texts[5]], k=2, generate=True, max_new_tokens=2,
        config=EngineConfig(n_slots=2, paged=True, paged_kernel=True, block_size=8,
                            prefill_chunk=16)))
    assert len(items) == 2 and all(len(it.tokens) == 2 and it._error is None for it in items)
