"""Port vs JAX at smoke size in fp32, with the same weights: qwen2-vl's
M-RoPE backbone through the converter, `prefill` + 3 `decode_step`s and
`paged_step` (gather path and K3's plain version against the JAX gather
path), with the default text positions and with three distinct position
channels."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_families import (TOL, check_convert, check_paged,  # noqa: E402
                             check_prefill_decode, models, paged_run, prompts)
from _torch_parity import to_numpy, to_torch  # noqa: E402

from repro.models import rope as jrope  # noqa: E402
from repro_torch.models import rope as trope  # noqa: E402

NAMES = ["qwen2-vl-72b"]


@pytest.mark.parametrize("name", NAMES)
def test_convert_places_every_leaf(name):
    check_convert(name)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_match(name):
    check_prefill_decode(name)


@pytest.mark.parametrize("paged_kernel", [False, True], ids=["gather", "k3_plain"])
@pytest.mark.parametrize("name", NAMES)
def test_paged_step_matches_jax_gather(name, paged_kernel):
    check_paged(name, paged_kernel)


def _mrope_positions(lengths, t):
    """(3, b, t) M-RoPE ids with three distinct channels: temporal = the
    text position, height = half of it + 2, width = it mod 3."""
    p = np.asarray(lengths)[:, None] + np.arange(t)[None, :]
    return np.stack([p, p // 2 + 2, p % 3]).astype(np.int32)


def test_mrope_three_distinct_channels():
    """`mrope_angles` itself, then `prefill` + `decode_step` and
    `paged_step` (both paths) with `positions=` whose channels differ."""
    jmodel, params, jpre, jdec, _, tmodel = models("qwen2-vl-72b")
    cfg = tmodel.cfg
    hd = cfg.resolved_head_dim
    pos = _mrope_positions([0, 7], 11)
    np.testing.assert_allclose(
        to_numpy(trope.mrope_angles(to_torch(pos), hd, cfg.rope_theta, cfg.mrope_sections)),
        np.asarray(jrope.mrope_angles(jnp.asarray(pos), hd, cfg.rope_theta,
                                      cfg.mrope_sections)), rtol=1e-6)
    with pytest.raises(ValueError, match="M-RoPE"):
        trope.mrope_angles(to_torch(pos[:2]), hd, cfg.rope_theta, cfg.mrope_sections)

    toks = prompts(2, 19, cfg.vocab_size, seed=4)
    ppos = _mrope_positions([0, 0], 19)
    jlog, jc = jpre(params, tokens=jnp.asarray(toks), cache_len=23,
                    positions=jnp.asarray(ppos))
    tlog, tc = tmodel.prefill(to_torch(toks).long(), cache_len=23, positions=to_torch(ppos))
    np.testing.assert_allclose(to_numpy(tlog), np.asarray(jlog), **TOL)
    plain, _ = tmodel.prefill(to_torch(toks).long(), cache_len=23)
    assert not np.allclose(to_numpy(plain), to_numpy(tlog), atol=1e-3)   # channels matter
    nxt = np.array([[5], [9]], np.int32)
    for _ in range(2):
        dpos = _mrope_positions(np.asarray(jc.length), 1)
        jlog, jc = jdec(params, jc, jnp.asarray(nxt), positions=jnp.asarray(dpos))
        tlog, tc = tmodel.decode_step(tc, to_torch(nxt).long(), positions=to_torch(dpos))
        np.testing.assert_allclose(to_numpy(tlog), np.asarray(jlog), **TOL)
        nxt = np.asarray(jnp.argmax(jlog, -1))[:, None].astype(np.int32)
    for pk in (False, True):
        logits, _ = paged_run("qwen2-vl-72b", pk, positions=_mrope_positions)
        for got, want in logits:
            np.testing.assert_allclose(got, want, **TOL)
