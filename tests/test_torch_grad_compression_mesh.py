"""`optim.grad_compression.compressed_psum` across spawned gloo ranks
(`_torch_dist`) against the JAX package in this process: at 1 rank bit
for bit against the JAX one inside a 1-device `shard_map`, at 2 ranks
bit for bit against the reference's arithmetic (each rank's INT8 q *
scale, summed, halved), and at 8 ranks the reference's case
(`test_sharding.py`: rows 0..7 average to 3.5 within 0.05). The error
feedback each rank keeps is g - q * scale."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_dist import Ranks, compressed_psum_run
from repro.core._compat import shard_map
from repro.optim import grad_compression as jax_gc
from repro_torch.launch.mesh import distributed, make_local_mesh
from repro_torch.optim import grad_compression

WORLDS = (2, 8)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: every rank's (reduced rows, error feedback)}."""
    root = tmp_path_factory.mktemp("psum")
    ranks = {w: Ranks(compressed_psum_run, w, str(root / f"store{w}"), 8) for w in WORLDS}
    return {w: r.results(timeout=150) for w, r in ranks.items()}


def test_compressed_psum_one_rank_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    g = {"a": rng.normal(size=(8, 16)).astype(np.float32),
         "b": rng.normal(size=(33,)).astype(np.float32) * 1e-3}
    e = {k: rng.normal(size=v.shape).astype(np.float32) * 1e-4 for k, v in g.items()}
    gmesh = jax.make_mesh((1,), ("data",))
    spec = {k: P("data") for k in g}
    jout, jerr = shard_map(lambda gl, el: jax_gc.compressed_psum(gl, el, ("data",)),
                           mesh=gmesh, in_specs=(spec, spec), out_specs=(spec, spec),
                           check_replication=True)(
        {k: jnp.asarray(v) for k, v in g.items()}, {k: jnp.asarray(v) for k, v in e.items()})
    with distributed(0, 1, store_path=str(tmp_path / "store"), device="cpu"):
        out, err = grad_compression.compressed_psum(
            {k: torch.from_numpy(v) for k, v in g.items()},
            {k: torch.from_numpy(v) for k, v in e.items()}, make_local_mesh(device="cpu"))
    for k in g:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]), err_msg=k)
        np.testing.assert_array_equal(err[k].numpy(), np.asarray(jerr[k]), err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_compressed_psum_across_ranks(runs, world):
    got = runs[world]
    rows = np.arange(8, dtype=np.float32)[:, None] * np.ones((8, 4), np.float32)
    per = 8 // world
    q_jit = jax.jit(jax_gc._q)
    parts = []
    for r in range(world):     # the reference's arithmetic on each rank's shard
        q, s = q_jit(jnp.asarray(rows[r * per:(r + 1) * per]))
        parts.append(np.asarray(q, np.float32) * np.float32(s))
    want = sum(parts[1:], parts[0]) / np.float32(world)
    for r, res in enumerate(got):
        np.testing.assert_array_equal(res["err"], rows[r * per:(r + 1) * per] - parts[r])
        if world == 2:
            np.testing.assert_array_equal(res["out"], want)
        else:   # gloo sums 8 values in its own order
            np.testing.assert_allclose(res["out"], want, rtol=1e-6)
            assert np.allclose(res["out"], 3.5, atol=0.05)
