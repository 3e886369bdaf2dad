"""The FSDP collective with autograd, `spmd.fsdp_gather`, and its
backward's reduce-scatter, `spmd.reduce_scatter_axes`, on 4 spawned gloo
ranks (`tests/_torch_dist.py`) against whole-tensor numpy:

  * forward: every rank's slice, in `flat_index` order along the dim,
    equals the whole tensor (dims 0 and 1; over `data` of 4, over `data`
    of 2 beside a `model` of 2, and over ("pod", "data") of 2 x 2, whose
    order is pod-major);
  * backward: each rank's gradient is the sum over the ranks it gathered
    with of their cotangents, at its slice (a reduce-scatter, not
    `gather_from_axes`' slice of its own cotangent), and
    `reduce_scatter_axes` of a cotangent is the same;
  * counts: one all-gather a gathered mesh dim in the forward, bytes of
    its output; one reduce-scatter a dim in the backward, bytes of its
    input; none in the other pass; under inference mode, the gather
    alone;
  * over axes of one rank (`data` of 1 beside a `model` of 4) it is the
    tensor itself, with no collective, as at world size 1 (a one-rank
    group in this process)."""
import math

import numpy as np
import pytest
import torch

from _torch_dist import Ranks, fsdp_collectives
from repro_torch import spmd
from repro_torch.launch.mesh import distributed, make_local_mesh

# (pod, data, model), gathered axes, dim
CASES = [((1, 4, 1), ("data",), 0), ((1, 4, 1), ("data",), 1),
         ((1, 2, 2), ("data",), 0), ((1, 2, 2), ("data",), 1),
         ((2, 2, 1), ("pod", "data"), 0), ((2, 2, 1), ("pod", "data"), 1),
         ((1, 1, 4), ("data",), 1)]
IDS = [f"{'x'.join(map(str, s))}-{'+'.join(a)}-dim{d}" for s, a, d in CASES]
SHAPE = (8, 12)


def _inputs(i: int):
    rng = np.random.default_rng(i)
    x = rng.normal(size=SHAPE).astype(np.float32)
    cot = rng.normal(size=(4, *SHAPE)).astype(np.float32)
    return x, cot


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cases = [(s, a, d, *_inputs(i)) for i, (s, a, d) in enumerate(CASES)]
        ranks = Ranks(fsdp_collectives, 4, str(tmp_path_factory.mktemp("fsdp") / "store"),
                      cases)
        return ranks.results(timeout=120)
    finally:
        torch.set_num_threads(n)


def _coords(rank: int, shape: tuple) -> dict:
    p, d, m = np.unravel_index(rank, shape)
    return {"pod": p, "data": d, "model": m}


def _peers(rank: int, shape: tuple, axes: tuple) -> list:
    """The ranks that share this rank's coordinates off `axes`."""
    mine = _coords(rank, shape)
    return [r for r in range(4) if all(_coords(r, shape)[a] == mine[a]
                                       for a in ("pod", "data", "model") if a not in axes)]


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_gather_and_its_reduce_scatter(runs, case):
    shape, axes, dim = CASES[case]
    x, cot = _inputs(case)
    sizes = dict(zip(("pod", "data", "model"), shape))
    wide = [a for a in axes if sizes[a] > 1]
    n = math.prod(sizes[a] for a in axes)
    rows = SHAPE[dim] // n
    itemsize = 4
    for rank, res in enumerate(runs):
        r = res[case]
        c = _coords(rank, shape)
        i = 0
        for a in axes:
            i = i * sizes[a] + c[a]
        np.testing.assert_array_equal(r["full"], x)
        np.testing.assert_array_equal(r["plain"], x)
        want = sum(cot[p] for p in _peers(rank, shape, axes))
        want = np.take(want, range(i * rows, (i + 1) * rows), axis=dim)
        np.testing.assert_allclose(r["grad"], want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r["scattered"], want, rtol=1e-6, atol=1e-6)
        # one gather a wide dim, the innermost first: its output grows
        out_bytes, in_bytes = [], []
        size = x.size // n
        for a in reversed(wide):
            size *= sizes[a]
            out_bytes.append(size * itemsize)
        size = x.size
        for a in wide:
            in_bytes.append(size * itemsize)
            size //= sizes[a]
        assert r["forward"]["all-gather"] == {"count": len(wide), "bytes": sum(out_bytes)}
        assert r["inference"]["all-gather"] == {"count": len(wide), "bytes": sum(out_bytes)}
        assert r["backward"]["reduce-scatter"] == {"count": len(wide), "bytes": sum(in_bytes)}
        for phase, skip in (("forward", "reduce-scatter"), ("backward", "all-gather"),
                            ("inference", "reduce-scatter")):
            assert r[phase][skip]["count"] == 0
            assert r[phase]["all-reduce"]["count"] == 0
        assert r["same"] == (not wide)


def test_world_size_1_is_the_tensor_itself(tmp_path):
    """A one-rank group: `fsdp_gather` returns its input, the reduce-scatter
    its input's values, and no collective is counted."""
    x = torch.randn(4, 6, requires_grad=True)
    with distributed(0, 1, store_path=str(tmp_path / "store"), device="cpu"):
        mesh = make_local_mesh(1, device="cpu")
        spmd.reset_collectives()
        assert spmd.fsdp_gather(x, mesh, ("data",), 0) is x
        g = torch.randn(4, 6)
        assert torch.equal(spmd.reduce_scatter_axes(g, mesh, ("data",), 1), g)
        assert torch.equal(spmd.all_reduce_axes(g.clone(), mesh, ("data", "model")), g)
        assert spmd.read_collectives()["total_bytes"] == 0
        assert all(spmd.read_collectives()[op]["count"] == 0 for op in spmd.COLLECTIVE_OPS)
