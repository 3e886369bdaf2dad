"""Spawned CPU ranks for the port's multi-rank tests
(test_torch_mesh_retrieval.py, test_torch_train_mesh.py,
test_torch_grad_compression_mesh.py).

`Ranks(fn, world, store, *args)` starts `world` fresh processes
(multiprocessing "spawn", one torch intra-op thread each, ROADMAP T44).
Each joins a gloo process group through a `FileStore` at `store`, a
path in a fresh directory (`launch.mesh.distributed`), reads the
arguments pickled beside it, calls `fn(rank, world, *args)` and sends
its result back: numpy arrays and plain values, since torch tensors
would travel as shared-memory handles that die with the rank.
`results()` waits for every rank; one that raises fails it with the
rank's traceback. This module and the rank functions import no JAX:
the JAX side of a comparison runs in the test process.
"""
from __future__ import annotations

import multiprocessing as mp
import pickle
import traceback

import numpy as np
import torch


def np_tree(x):
    """Tensors (DTensors whole) -> numpy, through dicts, lists and tuples."""
    if isinstance(x, torch.Tensor):
        full = getattr(x, "full_tensor", None)
        return (full() if full else x).detach().cpu().numpy().copy()
    if isinstance(x, dict):
        return {k: np_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(np_tree(v) for v in x)
    return x


def _entry(fn, rank: int, world: int, store: str, q) -> None:
    torch.set_num_threads(1)
    try:
        from repro_torch.launch.mesh import distributed

        with open(store + ".args", "rb") as f:
            args = pickle.load(f)
        with distributed(rank, world, store_path=store, device="cpu"):
            out = fn(rank, world, *args)
        q.put((rank, True, out))
    except BaseException:   # the parent reports it; the rank exits either way
        q.put((rank, False, traceback.format_exc()))


class Ranks:
    """`world` ranks running `fn(rank, world, *args)`, started at once;
    `results()` waits for them."""

    def __init__(self, fn, world: int, store: str, *args):
        # the arguments go through a file: a start() whose pickled
        # arguments overflow the pipe waits until that rank has imported
        # torch, and the ranks would start one after another
        with open(store + ".args", "wb") as f:
            pickle.dump(args, f)
        ctx = mp.get_context("spawn")
        self.world = world
        self.q = ctx.Queue()
        self.procs = [ctx.Process(target=_entry, args=(fn, r, world, store, self.q),
                                  daemon=True) for r in range(world)]
        for p in self.procs:
            p.start()

    def results(self, timeout: float = 120.0) -> list:
        """[fn's result on rank 0, ..., rank world - 1]."""
        out = {}
        try:
            for _ in range(self.world):
                rank, ok, res = self.q.get(timeout=timeout)
                if not ok:
                    raise AssertionError(f"rank {rank} of {self.world} failed:\n{res}")
                out[rank] = res
        finally:
            for p in self.procs:
                p.join(timeout=20 if len(out) == self.world else 1)
                if p.is_alive():
                    p.kill()
        assert all(p.exitcode == 0 for p in self.procs), [p.exitcode for p in self.procs]
        return [out[r] for r in range(self.world)]


# ---------------------------------------------------------------- retrieval
def index_runs(rank: int, world: int, emb: np.ndarray, queries: np.ndarray,
               cases: list, k: int) -> dict:
    """`ShardedDircIndex(parallelism="shard_map")` over the macro mesh of
    every rank: (path, metric, n_shards) -> (the macros this rank scored,
    scores (S, b, cap), top-k scores, top-k ids)."""
    from repro_torch.core import retrieval, sharded_index

    out = {}
    for path, metric, n_shards in cases:
        cfg = retrieval.RetrievalConfig(bits=8, metric=metric, path=path)
        idx = sharded_index.ShardedDircIndex.build(emb, cfg, n_shards=n_shards,
                                                   parallelism="shard_map", device="cpu")
        res = idx.search(queries, k)
        out[(path, metric, n_shards)] = (idx._macro_block(), np_tree(idx.scores(queries)),
                                         np_tree(res.scores), np_tree(res.indices))
    return out


def searcher_runs(rank: int, world: int, corpora: dict, q: np.ndarray, k: int,
                  model_par: int) -> dict:
    """`make_distributed_searcher` over the macro mesh and over the (world
    // model_par, model_par) local mesh (docs over both dims) for each
    corpus name -> (int8 codes, norms): (corpus, mesh, metric) -> (scores,
    ids), "whole" for whole tensors passed in; and the kernel launches
    the searches made (0 on the CPU)."""
    from repro_torch.core import sharded_index
    from repro_torch.kernels import score_matmul, topk_select
    from repro_torch.launch import mesh as mesh_mod

    out = {}
    meshes = {"macro": mesh_mod.make_macro_mesh(device="cpu"),
              "local": mesh_mod.make_local_mesh(model_par, device="cpu")}
    for corpus, (codes, norms) in corpora.items():
        codes, norms = torch.from_numpy(codes), torch.from_numpy(norms)
        for name, mesh in meshes.items():
            docs, dn = sharded_index.shard_index_arrays(mesh, codes, norms)
            for metric in ("cosine", "mips"):
                res = sharded_index.make_distributed_searcher(mesh, k, metric=metric)(
                    torch.from_numpy(q), docs, dn)
                out[(corpus, name, metric)] = (np_tree(res.scores), np_tree(res.indices))
            res = sharded_index.make_distributed_searcher(mesh, k)(
                torch.from_numpy(q), codes, norms)
            out[(corpus, name, "whole")] = (np_tree(res.scores), np_tree(res.indices))
    out["launches"] = topk_select.LAUNCHES + score_matmul.LAUNCHES
    return out


def uneven_refusals(rank: int, world: int, codes: np.ndarray, norms: np.ndarray,
                    q: np.ndarray, k: int) -> list:
    """What `shard_index_arrays` and the searcher (whole tensors) raise
    over a macro mesh whose rank count does not divide the docs: each
    ValueError's message, or None where nothing was raised."""
    from repro_torch.core import sharded_index
    from repro_torch.launch import mesh as mesh_mod

    mesh = mesh_mod.make_macro_mesh(device="cpu")
    codes, norms = torch.from_numpy(codes), torch.from_numpy(norms)
    search = sharded_index.make_distributed_searcher(mesh, k)
    out = []
    for call in (lambda: sharded_index.shard_index_arrays(mesh, codes, norms),
                 lambda: search(torch.from_numpy(q), codes, norms)):
        try:
            call()
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def retrieval_suite(rank: int, world: int, index_args: tuple, searcher_args: tuple) -> dict:
    return {"index": index_runs(rank, world, *index_args),
            "searcher": searcher_runs(rank, world, *searcher_args)}


# ---------------------------------------------------------------- training
def train_steps(rank: int, world: int, model_par: int, cfg, state: dict,
                batches: list, ocfg) -> dict:
    """`build_train_step(mesh=make_local_mesh(model_par))` over
    `train_model`'s tensor-parallel model from the given whole weights,
    over the given global batches: per-step metrics, and the parameters
    after them gathered whole (rank 0)."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.steps import build_train_step, init_sharded, train_model
    from repro_torch.models import sharding

    mesh = mesh_mod.make_local_mesh(model_par, device="cpu")
    model, _ = train_model(cfg, mesh, "cpu", state={k: torch.from_numpy(v)
                                                    for k, v in state.items()})
    step = build_train_step(cfg, ocfg, grad_accum=1, mesh=mesh)
    opt = init_sharded(dict(model.named_parameters()), cfg, mesh)
    metrics = []
    for b in batches:
        opt, m = step(model, opt, {k: torch.from_numpy(v).long() for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    whole = np_tree(sharding.gather_whole(model, mesh))
    return {"metrics": metrics, "params": whole if rank == 0 else None}


def compressed_psum_run(rank: int, world: int, rows: int) -> dict:
    """The reference's case: g is rows 0..rows-1 (row r all r, 4 wide)
    split over the data ranks; `compressed_psum` over them."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.optim import grad_compression

    mesh = mesh_mod.make_local_mesh(1, device="cpu")
    per = rows // world
    g = {"w": torch.arange(rank * per, (rank + 1) * per, dtype=torch.float32)[:, None]
         * torch.ones(per, 4)}
    out, err = grad_compression.compressed_psum(g, {"w": torch.zeros(per, 4)}, mesh)
    return {"out": np_tree(out["w"]), "err": np_tree(err["w"])}


def train_run(rank: int, world: int, kw: dict) -> dict:
    """`launch.train.train(**kw)` on this rank: its losses and grad norms."""
    from repro_torch.launch import train

    res = train.train(**kw)
    return {"losses": res["losses"], "grad_norms": res["grad_norms"]}


def jobs(rank: int, world: int, todo: list) -> list:
    """Several rank functions in one spawn: [(fn, args), ...] -> results."""
    return [fn(rank, world, *args) for fn, args in todo]


# ---------------------------------------------------------------- inference
def inference_steps(rank: int, world: int, model_par: int, cfg, state: dict,
                    decode: list, prefill: list, seq_len: int) -> dict:
    """`launch.steps`' serve and prefill steps over `make_local_mesh(
    model_par)` from the given whole weights. `decode` holds whole caches
    (a dict of the cache tree's leaves) and a token batch each, `prefill`
    whole batches. For each: this rank's data coordinate, the tokens of
    its rows, the logits of its rows over the whole vocabulary (the mesh
    gathers them), its cache shards after the step, the collectives one
    step issued and the FSDP gathers among them (`sharding.full`'s calls
    of `spmd.fsdp_gather`); and the bytes of the weights this rank
    holds."""
    from repro_torch import spmd
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    from repro_torch.models import layers, sharding

    gathers = []
    real_gather = sharding.fsdp_gather

    def counted(x, *args, **kwargs):
        gathers.append(x.shape)
        return real_gather(x, *args, **kwargs)
    sharding.fsdp_gather = counted
    mesh = mesh_mod.make_local_mesh(model_par, device="cpu")
    coord = (mesh.get_local_rank("data"), mesh.get_local_rank("model"))
    state = {k: torch.from_numpy(v) for k, v in state.items()}
    out = {"coord": coord, "decode": [], "prefill": []}
    for leaves, token in decode:
        shape = ShapeConfig("decode_32k", seq_len, token.shape[0], "decode")
        art = steps.build_serve_step(cfg, mesh, shape, device="cpu")
        art.load_state_dict(state)
        whole = art.model.init_caches(token.shape[0], seq_len, 0)
        whole = steps.map_caches(whole, lambda p, t: torch.from_numpy(leaves[p]))
        batch = art.local_batch({"token": torch.from_numpy(token)})

        def local():
            return steps.map_caches(art.local_caches(whole), lambda p, t: t.clone())
        spmd.reset_collectives()
        gathers.clear()
        tok, caches = art.fn(local(), batch)
        colls = spmd.read_collectives()
        n_gathers = len(gathers)
        n = len(tok)                      # the rows of this rank's data shard
        with art.context():
            mine = local()
            mine = mine._replace(length=mine.length[coord[0] * n:(coord[0] + 1) * n]
                                 if n < token.shape[0] else mine.length)
            logits = layers.gather_vocab(cfg, art.model.decode_step(mine, batch["token"])[0])
        out["decode"].append({"token": np_tree(tok), "logits": np_tree(logits),
                              "caches": np_tree(steps.cache_leaves(caches)),
                              "collectives": colls, "fsdp_gathers": n_gathers})
    out["param_bytes"] = sum(p.numel() * p.element_size() for p in art.model.parameters())
    for whole_batch in prefill:
        b, s = whole_batch["tokens"].shape
        art = steps.build_prefill_step(cfg, mesh, ShapeConfig("prefill_32k", s, b, "prefill"),
                                       device="cpu")
        art.load_state_dict(state)
        batch = art.local_batch({k: torch.from_numpy(v) for k, v in whole_batch.items()})
        spmd.reset_collectives()
        gathers.clear()
        tok = art.fn(batch)
        colls = spmd.read_collectives()
        n_gathers = len(gathers)
        with art.context(), torch.inference_mode():
            logits = layers.gather_vocab(cfg, steps.last_logits(art.model, batch))
        out["prefill"].append({"token": np_tree(tok), "logits": np_tree(logits),
                               "collectives": colls, "fsdp_gathers": n_gathers})
    sharding.fsdp_gather = real_gather
    return out


def greedy_ties(rank: int, world: int, model_par: int, cfg, logits: np.ndarray) -> np.ndarray:
    """`layers.greedy_token` over `model_par` ranks, each holding its
    columns of `logits` (b, V): the global argmax."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import layers, sharding

    mesh = mesh_mod.make_local_mesh(model_par, device="cpu")
    n = logits.shape[-1] // model_par
    r = mesh.get_local_rank("model")
    with sharding.sharding_ctx(mesh):
        return np_tree(layers.greedy_token(cfg, torch.from_numpy(logits[:, r * n:(r + 1) * n])))


# ------------------------------------------------------ tensor-parallel train
def tp_train(rank: int, world: int, model_par: int, cases: list, ocfg, pods: int = 1) -> dict:
    """For each case (name, cfg, whole state as numpy, global batches):
    `train_model`'s tensor-parallel model over `make_local_mesh(
    model_par)` from that state: the first batch's loss and gradients
    (whole: `sharding.whole_grads`), then `build_train_step(mesh=)` over
    every batch (per-step metrics, the first step's collectives) and the
    parameters after them, gathered whole (and rank 0's resident shards
    of them, `local`); the names of the weights cut over `model`
    (`split`) and over the data axes (`fsdp`); and whether the seeded
    init streamed into the shards equals the whole one's
    (`streamed_init_equal`). With `pods` > 1 the mesh is (pods, world //
    pods // model_par, model_par) over ("pod", "data", "model").
    Whole tensors come back from rank 0 only."""
    from repro_torch import spmd
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    from repro_torch.models import sharding
    from repro_torch.spmd import all_reduce_axes

    if pods == 1:
        mesh = mesh_mod.make_local_mesh(model_par, device="cpu")
    else:
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cpu", (pods, world // pods // model_par, model_par),
                                mesh_dim_names=("pod", "data", "model"))
    out = {}
    for name, cfg, state, batches in cases:
        model, plan = steps.train_model(cfg, mesh, "cpu",
                                        state={k: torch.from_numpy(v) for k, v in state.items()})
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        b0 = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
              for k, v in batches[0].items()}
        with sharding.sharding_ctx(mesh):
            loss, g = steps._grads(model, b0, params, 1, mesh, plan.data_axes)
        grads = sharding.whole_grads(g, params, mesh, plan.data_axes)
        loss = all_reduce_axes(loss.clone(), mesh, plan.data_axes)
        step = steps.build_train_step(cfg, ocfg, grad_accum=1, mesh=mesh)
        opt = steps.init_sharded(params, cfg, mesh)
        metrics, colls = [], None
        for b in batches:
            spmd.reset_collectives()
            opt, m = step(model, opt, {k: torch.from_numpy(v).long() if v.dtype == np.int32
                                       else torch.from_numpy(v) for k, v in b.items()})
            colls = colls or spmd.read_collectives()
            metrics.append({k: float(v) for k, v in m.items()})
        whole = sharding.gather_whole(model, mesh)
        out[name] = {"loss": float(loss), "metrics": metrics,
                     "init_equal": streamed_init_equal(cfg, mesh),
                     "split": sorted(n for n, p in params.items()
                                     if sharding.split_dim(p) is not None),
                     "fsdp": sorted(n for n, p in params.items()
                                    if sharding.fsdp_dim(p) is not None),
                     "collectives": colls,
                     "grads": np_tree(grads) if rank == 0 else None,
                     "params": np_tree(whole) if rank == 0 else None,
                     "local": (np_tree({n: p.detach() for n, p in params.items()})
                               if rank == 0 else None)}
    return out


def cross_cut(rank: int, world: int, model_par: int, cfg, state: dict, enc: np.ndarray,
              token: np.ndarray, seq_len: int) -> dict:
    """The audio serve step's model over `make_local_mesh(model_par)`
    from the given whole weights: `precompute_cross` of the encoder
    output `enc` (b, F, d) under the step's context (`k`, `v`), those
    K/V cut to this rank's frame shards by `local_caches` (`local_k`,
    `local_v`) and the serve step's token from zero self caches holding
    them (`token`); and which weights the step holds cut over `model`."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    from repro_torch.models import sharding

    mesh = mesh_mod.make_local_mesh(model_par, device="cpu")
    art = steps.build_serve_step(cfg, mesh, ShapeConfig("decode_32k", seq_len, token.shape[0],
                                                        "decode"), device="cpu")
    art.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    with art.context():
        k, v = art.model.precompute_cross(torch.from_numpy(enc))
    whole = art.model.init_caches(token.shape[0], seq_len, 0)._replace(cross_k=k, cross_v=v)
    local = steps.map_caches(art.local_caches(whole), lambda p, t: t.clone())
    tok, _ = art.fn(local, art.local_batch({"token": torch.from_numpy(token)}))
    return {"coord": mesh.get_local_rank("model"), "k": np_tree(k), "v": np_tree(v),
            "local_k": np_tree(local.cross_k), "local_v": np_tree(local.cross_v),
            "token": np_tree(tok),
            "split": sorted(n for n, p in art.model.named_parameters()
                            if sharding.split_dim(p) is not None)}


def streamed_init_equal(cfg, mesh) -> bool:
    """Whether `train_model(generator=)` (the seeded init cut a part at a
    time) holds on this rank the shards of the whole model's seeded init."""
    from repro_torch.launch import steps
    from repro_torch.models import build_model

    got, _ = steps.train_model(cfg, mesh, "cpu", generator=torch.Generator().manual_seed(11))
    whole = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(11))
    want, _ = steps.train_model(cfg, mesh, "cpu", state=whole.state_dict())
    want = dict(want.named_parameters())
    return all(torch.equal(p, want[n]) for n, p in got.named_parameters())


def vp_head_ce(rank: int, world: int, model_par: int, cases: list) -> list:
    """`layers.lm_head_loss` over a tied head split by vocabulary over
    `model` (this rank's rows of each case's whole (V, d) `w`, marked as
    cut along dim 0): for each case (cfg, hidden, w, labels), the loss,
    the hidden's gradient and the head's gradient gathered whole."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import layers, sharding
    from repro_torch.spmd import all_gather_axes

    mesh = mesh_mod.make_local_mesh(model_par, device="cpu")
    out = []
    for cfg, hidden, w, labels in cases:
        n = w.shape[0] // model_par
        r = mesh.get_local_rank("model")
        local = torch.nn.Parameter(torch.from_numpy(w[r * n:(r + 1) * n]).clone())
        local._tp_dim = 0
        h = torch.from_numpy(hidden).requires_grad_(True)
        with sharding.sharding_ctx(mesh):
            loss = layers.lm_head_loss(cfg, local, h, torch.from_numpy(labels).long())
        dh, dw = torch.autograd.grad(loss, [h, local])
        out.append({"loss": float(loss), "dh": np_tree(dh),
                    "dw": np_tree(all_gather_axes(dw, mesh, ("model",)))})
    return out


def gated_norm_grads(rank: int, world: int, model_par: int, cases: list) -> list:
    """`layers.gated_rmsnorm` on this rank's channels of x / z (b, s, c),
    the whole scale (c,), then a row-parallel projection (this rank's rows
    of w (c, d)) summed over `model`, under a loss of the output times a
    fixed weight: for each case (x, z, scale, w, weight), the loss and
    the gradients of x, z (gathered whole) and of the scale."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import layers, sharding
    from repro_torch.spmd import all_gather_axes

    mesh = mesh_mod.make_local_mesh(model_par, device="cpu")
    r = mesh.get_local_rank("model")
    out = []
    for x, z, scale, w, weight in cases:
        n = x.shape[-1] // model_par
        xl = torch.from_numpy(x[..., r * n:(r + 1) * n]).requires_grad_(True)
        zl = torch.from_numpy(z[..., r * n:(r + 1) * n]).requires_grad_(True)
        sc = torch.from_numpy(scale).requires_grad_(True)
        with sharding.sharding_ctx(mesh):
            y = layers.gated_rmsnorm(sc, xl, zl, 1e-5) @ torch.from_numpy(w[r * n:(r + 1) * n])
            loss = (sharding.tp_all_reduce(y) * torch.from_numpy(weight)).sum()
        dx, dz, ds = torch.autograd.grad(loss, [xl, zl, sc])
        out.append({"loss": float(loss), "dscale": ds.numpy().copy(),
                    "dx": all_gather_axes(dx, mesh, ("model",), dim=-1).numpy().copy(),
                    "dz": all_gather_axes(dz, mesh, ("model",), dim=-1).numpy().copy()})
    return out


def fp32_configs(train_mod) -> None:
    """Make `launch.train.train` build its configs in fp32 compute."""
    import dataclasses

    from repro_torch.configs import get_config

    train_mod.get_config = lambda arch, smoke=True: dataclasses.replace(
        get_config(arch, smoke=smoke), compute_dtype="float32")


def train_whole(rank: int, world: int, kw: dict) -> dict:
    """`launch.train.train(**kw)` on this rank with fp32 compute (a resume
    of a checkpoint at `steps` runs no step): its losses, and its
    parameters and AdamW state gathered whole by port name (rank 0)."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps, train
    from repro_torch.models import sharding

    fp32_configs(train)
    res = train.train(**kw)
    mesh = mesh_mod.make_local_mesh(kw.get("model_par", 1), device="cpu")
    params = sharding.gather_whole(res["model"], mesh)
    opt = steps.gather_state(res["opt"], res["model"].cfg)
    whole = {"params": np_tree(params), "step": int(opt.step), "master": np_tree(opt.master),
             "mu": np_tree(opt.mu), "nu": np_tree(opt.nu)}
    return {"losses": res["losses"], "whole": whole if rank == 0 else None}


def dryrun_counts(rank: int, world: int, model_par: int, cfg, shapes: list) -> list:
    """`launch.dryrun.count_cell` of each shape over `make_local_mesh(
    model_par)` on real CPU tensors: the counts this rank's program
    makes."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_mod

    mesh = mesh_mod.make_local_mesh(model_par, device="cpu")
    return [dryrun.count_cell(cfg, mesh, shape, device="cpu") for shape in shapes]


# ------------------------------------------------------------- MoE over data
def moe_params(p: dict, grad: bool = False):
    """`apply_moe`'s weights from numpy: `router`, `w_gate`, `w_up`,
    `w_down` and, where `p` has them, the dense residual's `dense_w_gate` /
    `dense_w_up` / `dense_w_down`; the router takes gradients with `grad`."""
    from types import SimpleNamespace

    t = {k: torch.from_numpy(v) for k, v in p.items()}
    out = SimpleNamespace(router=t["router"].requires_grad_(grad), w_gate=t["w_gate"],
                          w_up=t["w_up"], w_down=t["w_down"])
    if "dense_w_gate" in t:
        out.dense_residual = SimpleNamespace(w_gate=t["dense_w_gate"], w_up=t["dense_w_up"],
                                             w_down=t["dense_w_down"])
    return out


def moe_loss(cfg, p, x: torch.Tensor, gy: torch.Tensor, weight: float):
    """(y, aux, the loss a rank's step would take of them): the output
    against a fixed cotangent, plus the aux losses as `model.loss` weighs
    them, times this rank's label share `weight`."""
    from repro_torch.models.moe import apply_moe

    y, aux = apply_moe(cfg, p, x)
    loss = (y.float() * gy).sum() + weight * (cfg.moe.aux_loss_weight * aux.load_balance_loss
                                              + 1e-4 * aux.router_z_loss)
    return y, aux, loss


def moe_rows(rank: int, world: int, cases: list, pods: int = 1) -> list:
    """`models.moe.apply_moe` on this rank's block of rows of each case's
    whole input, as `launch.steps.shard_batch` cuts it, the batch axes
    installed as the row axes: those of `make_local_mesh(1)` (world ranks
    over `data`), or with `pods` > 1 of a (pods, world // pods, 1) mesh
    over ("pod", "data", "model"). For each case (cfg, params as numpy,
    x (b, s, d), cotangent of y, the ranks' label shares): this rank's y,
    its aux losses, the collectives of the forward, and the gradients of
    `moe_loss` for its x rows and the router."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import spmd
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.steps import shard_batch
    from repro_torch.models import sharding

    mesh = (mesh_mod.make_local_mesh(1, device="cpu") if pods == 1 else
            init_device_mesh("cpu", (pods, world // pods, 1),
                             mesh_dim_names=("pod", "data", "model")))
    axes = spmd.batch_axes(mesh)
    out = []
    for cfg, p, x, gy, shares in cases:
        cut = shard_batch({"x": torch.from_numpy(x), "gy": torch.from_numpy(gy)}, mesh)
        params = moe_params(p, grad=True)
        xl = cut["x"].clone().requires_grad_(True)
        spmd.reset_collectives()
        with sharding.sharding_ctx(mesh, row_axes=axes):
            y, aux, loss = moe_loss(cfg, params, xl, cut["gy"], shares[rank])
            fwd = spmd.read_collectives()
            dx, drouter = torch.autograd.grad(loss, [xl, params.router])
        out.append({"y": np_tree(y), "aux": [float(a.detach()) for a in aux],
                    "dropped": np_tree(aux.dropped_fraction),
                    "forward": {op: fwd[op]["count"] for op in spmd.COLLECTIVE_OPS},
                    "dx": np_tree(dx), "drouter": np_tree(drouter)})
    return out


# ------------------------------------------------------------------- FSDP
def fsdp_collectives(rank: int, world: int, cases: list) -> list:
    """`spmd.fsdp_gather` and `reduce_scatter_axes` on this rank. Each case
    is (mesh shape (pod, data, model), the axes to gather over, the dim,
    the whole tensor x, the cotangents (world, *x.shape)): this rank's
    slice of x along `dim` (its `flat_index` over the axes) gathered, and
    the gradient of sum(gathered * its own cotangent) for that slice, each
    with the collectives it issued; `reduce_scatter_axes` of its
    cotangent; the gather under inference mode."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import spmd

    out = []
    for shape, axes, dim, x, cot in cases:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("pod", "data", "model"))
        n = spmd.mesh_chips(mesh, axes)
        rows = x.shape[dim] // n
        i = spmd.flat_index(mesh, axes) if axes else 0
        mine = torch.from_numpy(x).narrow(dim, i * rows, rows).clone().requires_grad_(True)
        spmd.reset_collectives()
        full = spmd.fsdp_gather(mine, mesh, axes, dim)
        fwd = spmd.read_collectives()
        spmd.reset_collectives()
        (grad,) = torch.autograd.grad((full * torch.from_numpy(cot[rank])).sum(), [mine])
        bwd = spmd.read_collectives()
        scattered = spmd.reduce_scatter_axes(torch.from_numpy(cot[rank]), mesh, axes, dim)
        with torch.inference_mode():
            spmd.reset_collectives()
            plain = spmd.fsdp_gather(mine.detach(), mesh, axes, dim)
            inf = spmd.read_collectives()
        out.append({"full": np_tree(full), "grad": np_tree(grad), "forward": fwd,
                    "backward": bwd, "scattered": np_tree(scattered), "plain": np_tree(plain),
                    "inference": inf, "same": full is mine})
    return out
