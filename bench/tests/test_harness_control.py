"""The control: a lower precision in the port's place fails the
comparison. On the CPU at toy sizes; on the card at a cell's own size."""
import pytest
import torch

from bench import control, spec
from bench.tests import _smoke


CONTROL = {"search_gap": "search_gap_int4", "logit_gap": "logit_gap_fp8",
           "miss_share": "miss_share_fp8"}


def _holds(cell, out):
    """Every number the cell compares: the port within its limit, the
    control past it."""
    for name, limit in cell.load["limits"].items():
        assert out[name] <= limit < out[CONTROL[name]], (name, out)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _smoke.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ["toy.open", "toy.closed"])
def test_the_control_fails_on_the_cpu(root, cell):
    c = spec.cell(cell, root)
    _holds(c, control.control_seed(c, 6, 4.0, torch.device("cpu")))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["phi4-mini-rag.docqa-open", "phi3.5-moe-rag.longform-closed",
                                  "phi4-mini-rag.docqa-closed"])
def test_the_control_fails_on_the_card(card, cell):
    c = spec.cell(cell)
    _holds(c, control.control_seed(c, 2**31 + 101, 20.0, card))
