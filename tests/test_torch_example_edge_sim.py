"""`examples_torch/edge_sim.py` against `examples/edge_sim.py`: the
simulator walk prints the same lines, and `main` returns the numbers it
printed; without CUDA the twin refuses to run unless given `--device
cpu`."""
import pytest

from _torch_examples import printed, reference, twin


@pytest.fixture(scope="module")
def runs():
    return printed(reference("edge_sim").main), printed(twin("edge_sim").main, ["--device", "cpu"])


def test_stdout_equal_line_for_line(runs):
    (_, want), (_, got) = runs
    assert len(want) > 20
    assert got == want


def test_main_returns_what_it_printed(runs):
    _, (out, lines) = runs
    assert [(mb, bits) for mb, bits, _, _ in out["scaling"]] == \
        [(mb, bits) for mb in (0.25, 0.5, 1, 2, 4) for bits in (8, 4)]
    for mb, bits, us, uj in out["scaling"]:
        assert f"   {mb:5.2f} {bits:5d} {us:9.3f} {uj:9.4f}" in lines
    for dim, us, docs in out["folding"]:
        assert f"   dim {dim:5d}: {us:7.3f} us, {docs:6d} docs resident" in lines
    us_on, uj_on = out["detect"]["on"]
    assert f"   detect ON : {us_on:.3f} us, {uj_on:.4f} uJ" in lines


def test_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        twin("edge_sim").main([])
