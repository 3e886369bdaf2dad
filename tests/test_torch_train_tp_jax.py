"""The port's tensor-parallel train step on 4 spawned gloo ranks against
the reference's own sharded train step: `repro.launch.steps.
build_train_step(cfg, mesh)` (FSDP x TP under GSPMD, parameters and
gradients placed by `param_shardings`), jitted on a mesh of Auto axes
over 4 host devices at (data, model) = (1, 4) and (2, 2), in a
subprocess with `--xla_force_host_platform_device_count=4` (the
reference's own `make_local_mesh` has Explicit axes, on which its steps
fail: ROADMAP §3). Both start from the same weights (the JAX init,
converted) and take the same global batch: step 0's loss within 1e-5
and grad norm within 2e-5 (relative, ROADMAP T42), for phi4-mini's fp32
smoke model."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_dist import Ranks, jobs, tp_train
from _torch_steps import ROOT, flat
from _torch_train import batch_np, jax_model
from _torch_tp import OCFG

ARCH = "phi4-mini-3.8b"
SHAPES = [(1, 4), (2, 2)]

_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, %(src)r)
sys.path.insert(0, %(tests)r)
import jax, jax.numpy as jnp, numpy as np
from _torch_steps import auto_mesh
from _torch_train import JAX_OCFG, smoke_configs
from repro.launch.steps import build_train_step
from repro.models import build_model, sharding as sh
from repro.optim import adamw
assert jax.device_count() == 4
data = np.load(%(npz)r)
jcfg, _ = smoke_configs(%(arch)r)
tree = jax.eval_shape(build_model(jcfg).init, jax.random.key(0))
leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
params = jax.tree_util.tree_unflatten(
    jax.tree_util.tree_structure(tree),
    [jnp.asarray(data["p/" + sh._path_str(p)]) for p, _ in leaves])
batch = {k[2:]: jnp.asarray(data[k]) for k in data.files if k.startswith("b/")}
out = {}
for shape in %(shapes)r:
    mesh = auto_mesh(tuple(shape))
    fn = jax.jit(build_train_step(jcfg, mesh, JAX_OCFG, grad_accum=1).fn)
    with mesh, sh.sharding_ctx(mesh):
        _, _, met = fn(params, adamw.init(params), batch)
    out[f"{shape[0]}{shape[1]}"] = np.asarray([met["loss"], met["grad_norm"]], np.float64)
np.savez(%(out)r, **out)
print("ok")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_jax")
    _, params, tcfg, state = jax_model(ARCH)
    batch = batch_np(tcfg, b=4, s=32, seed=100)
    arrays = {f"p/{p}": np.asarray(v) for p, v in flat(params).items()}
    arrays.update({f"b/{k}": v for k, v in batch.items()})
    np.savez(tmp / "in.npz", **arrays)
    script = _SCRIPT % dict(src=os.path.join(ROOT, "src"), tests=os.path.join(ROOT, "tests"),
                            npz=str(tmp / "in.npz"), out=str(tmp / "out.npz"), arch=ARCH,
                            shapes=[list(s) for s in SHAPES])
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", script], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    case = [(ARCH, tcfg, {k: v.numpy() for k, v in state.items()}, [batch])]
    ranks = Ranks(jobs, 4, str(tmp / "store"), [(tp_train, (m, case, OCFG)) for _, m in SHAPES])
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        port = ranks.results(timeout=200)
    finally:
        torch.set_num_threads(n)
        _, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stderr[-3000:]
    return dict(np.load(tmp / "out.npz")), port


@pytest.mark.parametrize("i", range(len(SHAPES)), ids=[f"data{d}-model{m}" for d, m in SHAPES])
def test_step_0_matches_the_reference_4_devices(runs, i):
    ref, port = runs
    d, m = SHAPES[i]
    want_loss, want_norm = ref[f"{d}{m}"]
    for r in port:                       # every rank reports the same metrics
        got = r[i][ARCH]["metrics"][0]
        assert abs(got["loss"] - want_loss) <= 1e-5 * abs(want_loss), (got, want_loss)
        assert abs(got["grad_norm"] - want_norm) <= 2e-5 * want_norm, (got, want_norm)
    assert port[0][i][ARCH]["split"]     # the port's step ran tensor-parallel
