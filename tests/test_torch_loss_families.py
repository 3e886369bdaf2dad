"""The ssm, hybrid and audio families' `loss` and gradients against the
JAX package's `value_and_grad` on the same converted fp32 weights (the
audio family on injected frames), and remat "full" / "dots" against
none in every family."""
import dataclasses

import pytest
import torch

from _torch_train import (FAMILY_ARCHS, assert_grads_close, batch_np, fresh_port_model,  # noqa: F401
                          grads_pair, one_torch_thread, to_port)
from repro_torch.launch.steps import loss_and_grads


@pytest.mark.parametrize("family", ["ssm", "hybrid", "audio"])
def test_family_loss_and_grads(family):
    arch = FAMILY_ARCHS[family]
    cfg = fresh_port_model(arch).cfg
    jl, jg, tl, tg = grads_pair(arch, batch_np(cfg, seed=4))
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    assert_grads_close(jg, tg, 5e-5)


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "phi3.5-moe-42b-a6.6b", "mamba2-2.7b",
                                  "zamba2-2.7b", "whisper-small"])
def test_remat_modes_equal_none(arch):
    """remat "full" and "dots" recompute the same values: loss and every
    gradient equal those of remat "none"."""
    model = fresh_port_model(arch)
    b = to_port(batch_np(model.cfg, seed=3))
    out = {}
    for mode in ("none", "full", "dots"):
        model.cfg = dataclasses.replace(model.cfg, remat=mode)
        model.requires_grad_(True)
        out[mode] = loss_and_grads(model, b, dict(model.named_parameters()))
    for mode in ("full", "dots"):
        assert torch.equal(out[mode][0], out["none"][0]), mode
        for k, g in out["none"][1].items():
            assert torch.equal(out[mode][1][k], g), (mode, k)


