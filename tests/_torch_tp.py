"""Shared pieces of the tensor-parallel training tests
(tests/test_torch_train_tp*.py): the smoke configs in fp32, seeded whole
weights (norm scales and biases moved off 1 / 0), seeded global batches,
the world-size-1 and mesh-less runs in this process, and the checks at
ROADMAP T42's tolerances. The ranks themselves run `_torch_dist.tp_train`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from _torch_dist import Ranks, jobs, tp_train
from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.launch.mesh import distributed
from repro_torch.models import build_model
from repro_torch.optim import adamw

OCFG = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
MESHES = {(1, 2): (2, 2), (1, 4): (4, 4), (2, 2): (4, 2)}  # (data, model) -> (world, model_par)
B, S, N_STEPS = 4, 32, 3


def config(name: str):
    """The fp32 smoke config of a case: an arch's, or a variant of one."""
    fp32 = {"compute_dtype": "float32"}
    if name == "granite-bias":      # MQA, with q / k / v biases
        return dataclasses.replace(get_config("granite-34b", smoke=True), attn_bias=True, **fp32)
    if name == "gelu-layernorm":    # GELU MLP, LayerNorm, untied and soft-capped head,
        # full remat (the recompute issues the forward's collectives again)
        return dataclasses.replace(get_config("phi4-mini-3.8b", smoke=True), norm="layernorm",
                                   mlp="gelu", tie_embeddings=False, logit_softcap=30.0,
                                   vocab_size=500, remat="full", **fp32)
    if name == "moe-aux":           # a heavy aux loss: its gradient must enter once
        cfg = get_config("phi3.5-moe-42b-a6.6b", smoke=True)
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, aux_loss_weight=10.0),
                                   **fp32)
    if name == "zamba2-full-remat":
        return dataclasses.replace(get_config("zamba2-2.7b", smoke=True), remat="full", **fp32)
    if name.startswith("mamba2-g"):  # Mamba2 groups (T30, T64)
        return _mamba_groups(int(name[len("mamba2-g"):]), fp32)
    return dataclasses.replace(get_config(name, smoke=True), **fp32)


def _mamba_groups(g: int, fp32: dict):
    """mamba2's smoke model with `n_groups` g. At g 3 the width is 48, so
    12 heads read groups of 4: at `model` 2 a rank's 6 heads and at
    `model` 4 its 3 heads start or end inside a group (one group a head);
    at g 2 and 4 each rank's heads read whole groups, one or two."""
    cfg = get_config("mamba2-2.7b", smoke=True)
    d = 48 if g == 3 else cfg.d_model
    return dataclasses.replace(cfg, d_model=d, ssm=dataclasses.replace(cfg.ssm, n_groups=g),
                               **fp32)


def state(cfg, seed: int = 0) -> dict:
    """Whole seeded weights as numpy: the port's init, with every norm
    scale and bias moved off 1 / 0."""
    m = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in m.state_dict().items():
        v = v.numpy().copy()
        if "norm" in k or k.split(".")[-1] in ("bq", "bk", "bv"):
            v = v + 0.3 * rng.normal(size=v.shape).astype(v.dtype)
        out[k] = v
    return out


def batches(cfg, seed: int = 0) -> list:
    """N_STEPS global batches (B x S); the first holds 19 invalid labels
    in rows 0-1, so data ranks hold unequal label counts."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(N_STEPS):
        b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
        if cfg.family == "vlm":
            b["positions"] = rng.integers(0, S, (3, B, S)).astype(np.int32)
        if cfg.family == "audio":
            e = cfg.encoder
            b["frames"] = rng.normal(size=(B, e.n_frames, e.d_model)).astype(np.float32)
        out.append(b)
    out[0]["labels"][:2, :9] = -1
    out[0]["labels"][0, -1] = -1
    return out


def cases(names) -> list:
    return [(n, config(n), state(config(n)), batches(config(n))) for n in names]


def run(tmp, names: list, meshes: dict, extra: Optional[dict] = None) -> dict:
    """{(data, model): rank results} of `tp_train` for every mesh (spawned
    at once), and {"world1": its results, "meshless": (loss, grads,
    metrics, params) by case} run in this process meanwhile. `extra`
    {(data, model): [(fn, args), ...]} adds rank jobs after `tp_train` on
    that mesh's ranks; their results land under ("extra", (data,
    model)), a list a rank."""
    todo = cases(names)
    extra = extra or {}
    spawned = {shape: Ranks(jobs, world, str(tmp / f"store{world}{mp}"),
                            [(tp_train, (mp, [c for c in todo if c[0] in want], OCFG))]
                            + extra.get(shape, []))
               for shape, (world, mp, want) in meshes.items()}
    out = {}
    with distributed(0, 1, store_path=str(tmp / "store1"), device="cpu"):
        out["world1"] = tp_train(0, 1, 1, todo, OCFG)
    out["meshless"] = {name: meshless(cfg, st, bs) for name, cfg, st, bs in todo}
    for shape, r in spawned.items():
        res = r.results(timeout=150)
        out[shape] = [x[0] for x in res]
        if shape in extra:
            out[("extra", shape)] = [x[1:] for x in res]
    return out


def _port(b: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in b.items()}


def meshless(cfg, st: dict, bs: list, grads_only: bool = False):
    """The mesh-less step from the same weights: the first batch's loss
    and gradients, then every step's metrics and the final parameters
    (not with `grads_only`)."""
    model = build_model(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in st.items()})
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    loss, g = steps.loss_and_grads(model, _port(bs[0]), params)
    if grads_only:
        return float(loss), {k: v.detach().numpy() for k, v in g.items()}
    step = steps.build_train_step(cfg, OCFG, grad_accum=1)
    opt = adamw.init(params)
    metrics = []
    for b in bs:
        opt, m = step(model, opt, _port(b))
        metrics.append({k: float(v) for k, v in m.items()})
    return (float(loss), {k: v.detach().numpy() for k, v in g.items()}, metrics,
            {k: v.detach().numpy() for k, v in model.state_dict().items()})


def check_close(got: dict, want: dict) -> None:
    """ROADMAP T42: step 0's loss within 1e-5 and grad norm within 2e-5
    (relative), later steps 1e-4 / 1e-3; every gradient of the first
    batch within 5e-5 of its largest magnitude; the parameters after the
    steps within 2e-3 at lr 1e-2."""
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        tol_loss, tol_norm = (1e-5, 2e-5) if i == 0 else (1e-4, 1e-3)
        assert abs(g["loss"] - w["loss"]) <= tol_loss * abs(w["loss"]), (i, g, w)
        assert abs(g["grad_norm"] - w["grad_norm"]) <= tol_norm * w["grad_norm"], (i, g, w)
    assert set(got["grads"]) == set(want["grads"])
    for k, g in got["grads"].items():
        scale = float(np.abs(want["grads"][k]).max())
        err = float(np.abs(g - want["grads"][k]).max())
        assert err <= 5e-5 * max(scale, 1e-30), (k, err, scale)
    for k, v in got["params"].items():
        np.testing.assert_allclose(v, want["params"][k], rtol=0, atol=2e-3, err_msg=k)
