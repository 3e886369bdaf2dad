"""Sharded training over a device mesh, on spawned gloo ranks
(`_torch_dist`), against world size 1 and the JAX package in this
process:

  * `build_train_step(mesh=make_local_mesh(model_par))` on phi4-mini's
    fp32 smoke model at (data, model) = (2, 1), (1, 2) and (2, 2), 3
    steps from the converted JAX init, against the mesh-less port step
    and the jitted JAX step at ROADMAP T42's tolerances. The first batch
    gives rank 0's half 16 fewer valid labels than rank 1's: a mean of
    the ranks' means would miss the loss by far more than 1e-5;
  * a MoE config over a data axis of 2 is refused by name;
  * `launch.train.train` checkpoints under (2, 1) and resumes under (1,
    1) and mesh-less: the same losses, bit for bit, and the resumed
    step's loss equal to the sharded run's within 1e-5.
The spawned ranks run while the JAX step compiles. `compressed_psum`
across ranks is in test_torch_grad_compression_mesh.py."""
import dataclasses

import jax
import numpy as np
import pytest

from _torch_dist import Ranks, jobs, moe_refusal, train_run, train_steps
from _torch_train import (JAX_OCFG, OCFG, batch_np, jax_model, one_torch_thread,  # noqa: F401
                          to_jax, to_port)
from repro.launch.mesh import make_local_mesh as jax_local_mesh
from repro.launch.steps import build_train_step as jax_build_train_step
from repro.models import sharding as jax_sharding
from repro.optim import adamw as jax_adamw
from repro_torch.configs import get_config
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import distributed
from repro_torch.launch.steps import build_train_step
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adamw

ARCH = "phi4-mini-3.8b"
MESHES = {(2, 1): (2, 1), (1, 2): (2, 2), (2, 2): (4, 2)}   # (data, model) -> (world, model_par)
TRAIN_KW = dict(arch=ARCH, smoke=True, steps=6, batch=4, seq=16, lr=1e-2, ckpt_every=4,
                log_every=100, device="cpu")


def _batches(cfg) -> list:
    out = [batch_np(cfg, b=4, s=32, seed=100 + i) for i in range(3)]
    out[0]["labels"][:2, :8] = -1     # rows 0-1 (data rank 0): 16 + 1 labels fewer
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX metrics and params, mesh-less port metrics and params,
    {(data, model): rank results}, the ranks of the other checks)."""
    jm, params, tcfg, state = jax_model(ARCH)
    batches = _batches(tcfg)
    moe_cfg = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b", smoke=True),
                                  compute_dtype="float32")
    root = tmp_path_factory.mktemp("mesh")
    ckpt = str(root / "ckpt")
    spawned = {}
    for shape, (world, model_par) in MESHES.items():
        todo = [(train_steps, (model_par, tcfg, {k: v.numpy() for k, v in state.items()},
                               batches, OCFG))]
        if shape == (2, 1):
            todo += [(moe_refusal, (moe_cfg,)), (train_run, (dict(TRAIN_KW, ckpt_dir=ckpt),))]
        spawned[shape] = Ranks(jobs, world, str(root / f"store{world}{model_par}"), todo)
    # the JAX step and the mesh-less port step over the same batches
    mesh = jax_local_mesh()
    fn = jax.jit(jax_build_train_step(jm.cfg, mesh, JAX_OCFG, grad_accum=1).fn)
    jopt = jax_adamw.init(params)
    tm = build_model(tcfg, device="cpu")
    tm.load_state_dict(state)
    step = build_train_step(tcfg, OCFG, grad_accum=1)
    topt = adamw.init(dict(tm.named_parameters()))
    jms, tms = [], []
    for b in batches:
        with mesh, jax_sharding.sharding_ctx(mesh):
            params, jopt, jmet = fn(params, jopt, to_jax(b))
        topt, tmet = step(tm, topt, to_port(b))
        jms.append({k: float(v) for k, v in jmet.items()})
        tms.append({k: float(v) for k, v in tmet.items()})
    jparams = {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, params),
                                                         tcfg).items()}
    tparams = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    got = {k: r.results(timeout=150) for k, r in spawned.items()}
    return (jms, jparams), (tms, tparams), got, ckpt


def _close(got: list, want: list, params: dict, want_params: dict) -> None:
    """ROADMAP T42: step 0's loss within 1e-5 and grad norm within 2e-5
    (relative), later steps 1e-4 / 1e-3; params within 2e-3 at lr 1e-2."""
    for i, (g, w) in enumerate(zip(got, want)):
        tol_loss, tol_norm = (1e-5, 2e-5) if i == 0 else (1e-4, 1e-3)
        assert abs(g["loss"] - w["loss"]) <= tol_loss * abs(w["loss"]), (i, g, w)
        assert abs(g["grad_norm"] - w["grad_norm"]) <= tol_norm * w["grad_norm"], (i, g, w)
        assert abs(g["lr"] - w["lr"]) <= 1e-6 * w["lr"]
    for k, v in params.items():
        np.testing.assert_allclose(v, want_params[k], rtol=0, atol=2e-3, err_msg=k)


@pytest.mark.parametrize("shape", list(MESHES), ids=lambda s: f"data{s[0]}-model{s[1]}")
@pytest.mark.parametrize("against", ["world1", "jax"])
def test_sharded_step_tracks(runs, shape, against):
    (jms, jparams), (tms, tparams), got, _ = runs
    res = [r[0] for r in got[shape]]
    want, want_params = (tms, tparams) if against == "world1" else (jms, jparams)
    _close(res[0]["metrics"], want, res[0]["params"], want_params)
    for r in res[1:]:   # every rank reports the same metrics
        assert r["metrics"] == res[0]["metrics"]


def test_unequal_label_counts_take_the_global_mean(runs):
    """The first batch's ranks hold 47 and 63 valid labels: the loss is
    the mean over all 110, as the mesh-less step's is."""
    _, (tms, _), got, _ = runs
    b = _batches(get_config(ARCH, smoke=True))[0]
    counts = [(b["labels"][r * 2:(r + 1) * 2] >= 0).sum() for r in range(2)]
    assert counts[0] + 16 == counts[1]
    loss = got[(2, 1)][0][0]["metrics"][0]["loss"]
    assert abs(loss - tms[0]["loss"]) <= 1e-6 * tms[0]["loss"]


def test_moe_over_a_data_axis_refused(runs):
    msg = [r[1] for r in runs[2][(2, 1)]]
    assert all("MoE routing over the global batch" in m and "ROADMAP" in m for m in msg)


def test_checkpoint_restores_under_another_mesh(runs, tmp_path):
    """Saved under (2, 1) at step 4; resumed under a (1, 1) mesh and with
    no mesh at all."""
    sharded = runs[2][(2, 1)][0][2]
    ckpt = runs[3]
    with distributed(0, 1, store_path=str(tmp_path / "store"), device="cpu"):
        one = train_mod.train(**dict(TRAIN_KW, ckpt_dir=ckpt, ckpt_every=100))
    bare = train_mod.train(**dict(TRAIN_KW, ckpt_dir=ckpt, ckpt_every=100))
    assert len(one["losses"]) == 2 and one["losses"] == bare["losses"]
    assert one["grad_norms"] == bare["grad_norms"]
    assert abs(one["losses"][0] - sharded["losses"][4]) <= 1e-5 * sharded["losses"][4]
    assert all(np.isfinite(one["losses"]))
