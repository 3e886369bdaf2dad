"""FSDP's placement as data: each weight's resident shard against the
reference's local shard, for every arch, its smoke config and its
published one, at (data, model) = (2, 2), (4, 1), (1, 4), (16, 16) and
(pod, data, model) = (2, 16, 16).

The port's shards are the shapes `sharding.shard_model` gives a model
built on the meta device over the mesh as a bare shape (no process
group): the train placement (`param_shardings`, the resident specs of
`sharding.port_specs`) and the inference placement
(`launch.steps.build_prefill_step`'s model, which `inference_rules`
places). The reference's are `NamedSharding.shard_shape` of its
`param_shardings` / `inference_param_shardings` on a
`jax.sharding.AbstractMesh` of the same shape, over `jax.eval_shape` of
its init. A stacked leaf's layer dim is the one place they part on
purpose: the port holds its layers as separate tensors and every rank
holds every layer (`sharding.resident_spec`), so where the reference's
rules cut that dim (the experts' rule on Arctic's dense residual, whose
stacked (L, d, f) leaf lines its L up with `expert`), the port's shard
keeps L whole and matches the reference's on the other dims. The marks
the layers read are held too: `split_dim` where the reference cuts over
`model`, `fsdp_dim` / `fsdp_axes` where it cuts over `data`."""
import pytest

from _torch_fsdp import MESH_IDS, MESHES, SIZES, check
from repro.configs import all_archs


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", all_archs())
def test_train_shards_are_the_reference_shards(arch, shape):
    for size in SIZES:
        n = check(arch, size, shape, "train")
        if shape["data"] > 1 and size == "published":
            assert n > 0, "the train placement cuts nothing over data"

