"""`models.moe.apply_moe` with its batch rows split over the batch axes
(`sharding_ctx(row_axes=)`) on spawned gloo ranks, D = 2 and 4 over
`data` and 2 x 2 over ("pod", "data") (whose gather order must be the
order `shard_batch` cuts the rows in), against the whole-batch call in
this process (`tests/_torch_dist.py`).

The reference routes the global batch: capacity from the global T,
ranks in global token order, global drops, aux means over every row.
Each rank's output rows and the dropped fraction equal the whole-batch
call's bit for bit at fp32 (its pairs land in their global slots of an
(E, C + 1, d) buffer of the mesh-less shape); the aux losses agree
within 1e-6. The cases: phi3.5-moe's and arctic's smoke layers at a
prefill shape and at decode shapes that drop pairs, and one whose
expert 0 takes every token, so that its capacity boundary falls inside
a later rank's rows. The gradients of a step's loss (the output against
a fixed cotangent, plus the aux losses weighted 10, times the rank's
label share) summed over the ranks equal the whole batch's within 1e-5
of their largest: the aux statistic's backward sums the ranks' shares
(an identity backward gives each rank its share alone). At world size 1
the row axes issue no collective and the call is the mesh-less one bit
for bit."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_dist import Ranks, jobs, moe_loss, moe_params, moe_rows
from repro_torch import spmd
from repro_torch.configs import get_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import sharding

# name -> (arch, b, s); "crossing" takes x along expert 0's router column
CASES = {"phi-prefill": ("phi3.5-moe-42b-a6.6b", 8, 4),
         "phi-decode": ("phi3.5-moe-42b-a6.6b", 8, 1),
         "arctic-prefill": ("arctic-480b", 8, 4),
         "arctic-decode": ("arctic-480b", 8, 1),
         "crossing": ("phi3.5-moe-42b-a6.6b", 8, 2)}
WORLDS = {"D2": (2, 1), "D4": (4, 1), "pod2-D2": (4, 2)}    # -> (ranks, pods)
SHARES = {2: [0.3, 0.7], 4: [0.1, 0.2, 0.3, 0.4]}    # unequal label shares, summing to 1


def _cfg(arch: str):
    cfg = get_config(arch, smoke=True)
    return dataclasses.replace(cfg, compute_dtype="float32",
                               moe=dataclasses.replace(cfg.moe, aux_loss_weight=10.0))


def _case(name: str, seed: int) -> tuple:
    """(cfg, params as numpy, x (b, s, d), cotangent of y)."""
    arch, b, s = CASES[name]
    cfg = _cfg(arch)
    rng = np.random.default_rng(seed)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts

    def normal(shape, std):
        return (std * rng.normal(size=shape)).astype(np.float32)
    p = {"router": normal((d, E), d ** -0.5), "w_gate": normal((E, d, f), d ** -0.5),
         "w_up": normal((E, d, f), d ** -0.5), "w_down": normal((E, f, d), f ** -0.5)}
    if cfg.moe.dense_residual_d_ff:
        r = cfg.moe.dense_residual_d_ff
        p.update(dense_w_gate=normal((d, r), d ** -0.5), dense_w_up=normal((d, r), d ** -0.5),
                 dense_w_down=normal((r, d), r ** -0.5))
    x = normal((b, s, d), 1.0)
    if name == "crossing":
        col = p["router"][:, 0] / np.linalg.norm(p["router"][:, 0])
        x = (0.1 * x + 4.0 * col).astype(np.float32)
    return cfg, p, x, normal((b, s, d), 1.0)


def _whole(cfg, p, x, gy):
    """The whole-batch call, no mesh: (y, aux, dx, drouter)."""
    params = moe_params(p, grad=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux, loss = moe_loss(cfg, params, xt, torch.from_numpy(gy), 1.0)
    dx, drouter = torch.autograd.grad(loss, [xt, params.router])
    return y.detach(), type(aux)(*(a.detach() for a in aux)), dx, drouter


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: each rank's `moe_rows` results}, the cases by name."""
    root = tmp_path_factory.mktemp("moe_data")
    cases = {name: _case(name, i) for i, name in enumerate(CASES)}
    spawned = {key: Ranks(jobs, w, str(root / f"store{key}"),
                          [(moe_rows, ([c + (SHARES[w],) for c in cases.values()], pods))])
               for key, (w, pods) in WORLDS.items()}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {w: [r[0] for r in s.results(timeout=150)] for w, s in spawned.items()}, cases
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("name", list(CASES))
def test_rows_equal_the_whole_batch_bit_for_bit(runs, name, world):
    res, cases = runs
    i = list(CASES).index(name)
    y, aux, _, _ = _whole(*cases[name])
    got = np.concatenate([r[i]["y"] for r in res[world]])
    np.testing.assert_array_equal(got, y.numpy())
    for r in res[world]:
        np.testing.assert_array_equal(r[i]["dropped"], aux.dropped_fraction.numpy())
        for a, want in zip(r[i]["aux"][:2], aux[:2]):
            assert abs(a - float(want)) <= 1e-6 * max(1.0, abs(float(want))), (a, float(want))
        n_axes = 1 + (WORLDS[world][1] > 1)        # a collective a mesh dim
        assert r[i]["forward"] == {"all-reduce": n_axes, "all-gather": n_axes,
                                   "reduce-scatter": 0}
    if name.endswith("decode"):
        assert float(aux.dropped_fraction) > 0, "the decode case drops no pair"


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("name", list(CASES))
def test_gradients_sum_to_the_whole_batch_s(runs, name, world):
    res, cases = runs
    i = list(CASES).index(name)
    _, _, dx, drouter = _whole(*cases[name])
    got_dx = np.concatenate([r[i]["dx"] for r in res[world]])
    got_router = sum(r[i]["drouter"] for r in res[world])
    for got, want in ((got_dx, dx.numpy()), (got_router, drouter.numpy())):
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= 1e-5 * scale


def test_the_crossing_case_crosses_inside_a_later_rank():
    """Expert 0 takes every token first, more than its capacity, and the
    pair at global rank C and the one before it lie in the same rank's
    rows, past rank 0's, at D 2 and 4."""
    from repro_torch.models.moe import capacity, route

    cfg, p, x, _ = _case("crossing", list(CASES).index("crossing"))
    b, s, d = x.shape
    T = b * s
    logits = torch.from_numpy(x.reshape(T, d)) @ torch.from_numpy(p["router"])
    _, idx = route(torch.softmax(logits, dim=-1), cfg.moe.top_k)
    tokens = torch.nonzero(idx.reshape(-1) == 0)[:, 0] // cfg.moe.top_k
    C = capacity(T, cfg)
    assert (idx[:, 0] == 0).all() and len(tokens) > C
    for world in (2, 4):
        owner = tokens // (T // world)
        assert owner[C] >= 1 and owner[C] == owner[C - 1], (world, owner.tolist())


def test_world_size_1_is_the_mesh_less_call(tmp_path):
    """Row axes over a data axis of 1: no collective, and the call is the
    mesh-less one bit for bit, aux losses included."""
    for name in ("phi-decode", "arctic-prefill"):
        cfg, p, x, gy = _case(name, list(CASES).index(name))
        y, aux, dx, drouter = _whole(cfg, p, x, gy)
        with mesh_mod.distributed(0, 1, store_path=str(tmp_path / f"store{name}"),
                                  device="cpu"):
            mesh = mesh_mod.make_local_mesh(1, device="cpu")
            spmd.reset_collectives()
            with sharding.sharding_ctx(mesh, row_axes=("data",)):
                got = _whole(cfg, p, x, gy)
            assert spmd.read_collectives()["total_bytes"] == 0
        assert torch.equal(got[0], y)
        for a, b in zip(got[1], aux):
            assert torch.equal(a, b)
        assert torch.equal(got[2], dx) and torch.equal(got[3], drouter)
