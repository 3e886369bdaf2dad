"""Port vs JAX: the spatial error maps, bit->cell remapping, and the
Sigma-D sensing channel. With the JAX package's own flips replayed
through the port's flip hook, `sense_with_detection` is exactly equal;
the port's own generator is checked statistically."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_parity import jax_flip_masks, to_numpy, to_torch  # noqa: E402

from repro.core import bitplane as jb  # noqa: E402
from repro.core import error_detection as jd  # noqa: E402
from repro.core import error_model as jem  # noqa: E402
from repro.core import remapping as jrm  # noqa: E402
from repro_torch.core import error_detection as td  # noqa: E402
from repro_torch.core import error_model as tem  # noqa: E402
from repro_torch.core import remapping as trm  # noqa: E402


def _cfgs(jitter):
    kw = dict(enabled=True, p_min=2e-2, p_max=1.2e-1, jitter_sigma=jitter, seed=3)
    return jem.ErrorModelConfig(**kw), tem.ErrorModelConfig(**kw)


@pytest.mark.parametrize("strategy", ["interleaved", "grouped", "error_aware"])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("jitter", [0.0, 0.5])
def test_maps_and_mappings_equal(strategy, bits, jitter):
    jcfg, tcfg = _cfgs(jitter)
    np.testing.assert_array_equal(tem.lsb_error_map(tcfg), jem.lsb_error_map(jcfg))
    np.testing.assert_array_equal(tem.msb_error_map(tcfg), jem.msb_error_map(jcfg))
    jm = jrm.build_mapping(strategy, bits=bits, error_cfg=jcfg)
    tm = trm.build_mapping(strategy, bits=bits, error_cfg=tcfg)
    np.testing.assert_array_equal(tm, jm)
    trm.validate_mapping(tm, bits)
    np.testing.assert_array_equal(tem.flip_probs_for_mapping(tm, tcfg),
                                  jem.flip_probs_for_mapping(jm, jcfg))


def _image(bits, n=96, dim=128, seed=0):
    rng = np.random.default_rng(seed)
    lo = -(1 << (bits - 1))
    v = rng.integers(lo, -lo, size=(n, dim)).astype(np.int8)
    planes = np.asarray(jb.to_bitplanes(jnp.asarray(v), bits=bits))
    lut = np.asarray(jb.sum_d_lut(jnp.asarray(planes)))
    return planes, lut


@pytest.mark.parametrize("detect", [True, False])
@pytest.mark.parametrize("max_retries", [0, 2])
@pytest.mark.parametrize("bits", [4, 8])
def test_sense_with_detection_exact_with_replayed_flips(detect, max_retries, bits):
    jcfg, _ = _cfgs(0.25)
    probs = jem.flip_probs_for_mapping(
        jrm.build_mapping("grouped", bits=bits, error_cfg=jcfg), jcfg).astype(np.float32)
    planes, lut = _image(bits)
    key = jax.random.key(11)
    want = jd.sense_with_detection(jnp.asarray(planes), jnp.asarray(lut),
                                   jnp.asarray(probs), key,
                                   max_retries=max_retries, detect=detect)
    flips = jax_flip_masks(key, probs, planes.shape, max_retries, detect)
    got = td.sense_with_detection(to_torch(planes), to_torch(lut), to_torch(probs),
                                  max_retries=max_retries, detect=detect, flips=flips)
    np.testing.assert_array_equal(to_numpy(got.planes), np.asarray(want.planes))
    assert int(got.detected) == int(want.detected)
    assert int(got.residual_planes) == int(want.residual_planes)
    assert int(got.rounds) == int(want.rounds)
    np.testing.assert_array_equal(to_numpy(got.detected_map), np.asarray(want.detected_map))
    if detect and max_retries:
        assert int(got.detected) > 0     # the probabilities make detection fire


def test_flip_hook_checks_round_count():
    planes, lut = _image(8, n=16)
    probs = torch.full((16, 8), 0.1)
    with pytest.raises(ValueError):
        td.sense_with_detection(to_torch(planes), to_torch(lut), probs,
                                max_retries=2, detect=True,
                                flips=[torch.zeros(planes.shape, dtype=torch.uint8)])


def test_generator_flip_rates_statistical():
    """The port's own draws: per-(slot, bit) flip rates match the
    probabilities within 5 binomial sigmas, and a seed reproduces."""
    n, bits, dim, n_slots = 512, 8, 128, 16
    probs = torch.linspace(0.0, 0.2, n_slots * bits).reshape(n_slots, bits)
    planes = torch.zeros((n, bits, dim), dtype=torch.uint8)
    g = torch.Generator().manual_seed(0)
    flipped = tem.apply_sense_errors(planes, probs, g).float()
    per_slot = flipped.reshape(n // n_slots, n_slots, bits, dim).mean(dim=(0, 3))
    trials = n // n_slots * dim
    sigma = torch.sqrt(probs * (1 - probs) / trials)
    assert bool(((per_slot - probs).abs() <= 5 * sigma + 1e-6).all())
    assert float(per_slot[0, 0]) == 0.0
    again = tem.apply_sense_errors(planes, probs, torch.Generator().manual_seed(0))
    assert torch.equal(again.float(), flipped)


def test_generator_detection_statistics():
    """With the port's generator, detection fires at the JAX package's
    rate: the first-round detected planes agree with JAX's mean over seeds
    within a few sigmas."""
    jcfg, _ = _cfgs(0.0)
    probs = jem.flip_probs_for_mapping(
        jrm.build_mapping("grouped", bits=8, error_cfg=jcfg), jcfg).astype(np.float32)
    planes, lut = _image(8, n=64)
    seeds = range(8)
    jax_rate = np.mean([int(np.asarray(jd.sense_with_detection(
        jnp.asarray(planes), jnp.asarray(lut), jnp.asarray(probs),
        jax.random.key(s), max_retries=0).detected_map).sum()) for s in seeds])
    port_rate = np.mean([int(td.sense_with_detection(
        to_torch(planes), to_torch(lut), to_torch(probs),
        torch.Generator().manual_seed(s), max_retries=0).detected_map.sum())
        for s in seeds])
    # each plane is flagged with probability ~ 1 - P(no or compensating flips)
    n_planes = planes.shape[0] * planes.shape[1]
    sigma = np.sqrt(n_planes * 0.25 / len(seeds))
    assert port_rate > 0 and abs(port_rate - jax_rate) <= 6 * sigma
