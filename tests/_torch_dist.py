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
    """`build_train_step(mesh=make_local_mesh(model_par))` from the given
    weights over the given global batches: per-step metrics, and the
    parameters after them (rank 0)."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.steps import build_train_step, init_sharded
    from repro_torch.models import build_model

    mesh = mesh_mod.make_local_mesh(model_par, device="cpu")
    model = build_model(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    step = build_train_step(cfg, ocfg, grad_accum=1, mesh=mesh)
    opt = init_sharded(dict(model.named_parameters()), cfg, mesh)
    metrics = []
    for b in batches:
        opt, m = step(model, opt, {k: torch.from_numpy(v).long() for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics,
            "params": np_tree(model.state_dict()) if rank == 0 else None}


def moe_refusal(rank: int, world: int, cfg) -> str:
    """The error `build_train_step` raises for a MoE config over a (world,
    1) mesh."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.steps import build_train_step

    try:
        build_train_step(cfg, mesh=mesh_mod.make_local_mesh(1, device="cpu"))
    except NotImplementedError as e:
        return str(e)
    return ""


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
    gathers them), its cache shards after the step, and the collectives
    one step issued; and the bytes of the weights this rank holds."""
    from repro_torch import spmd
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    from repro_torch.models import layers

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
            return type(whole)(*(t.clone() for t in art.local_caches(whole)))
        spmd.reset_collectives()
        tok, caches = art.fn(local(), batch)
        colls = spmd.read_collectives()
        n = len(tok)                      # the rows of this rank's data shard
        with art.context():
            mine = local()
            mine = mine._replace(length=mine.length[coord[0] * n:(coord[0] + 1) * n]
                                 if n < token.shape[0] else mine.length)
            logits = layers.gather_vocab(cfg, art.model.decode_step(mine, batch["token"])[0])
        out["decode"].append({"token": np_tree(tok), "logits": np_tree(logits),
                              "caches": np_tree(steps.cache_leaves(caches)),
                              "collectives": colls})
    out["param_bytes"] = sum(p.numel() * p.element_size() for p in art.model.parameters())
    for whole_batch in prefill:
        b, s = whole_batch["tokens"].shape
        art = steps.build_prefill_step(cfg, mesh, ShapeConfig("prefill_32k", s, b, "prefill"),
                                       device="cpu")
        art.load_state_dict(state)
        batch = art.local_batch({k: torch.from_numpy(v) for k, v in whole_batch.items()})
        spmd.reset_collectives()
        tok = art.fn(batch)
        colls = spmd.read_collectives()
        with art.context(), torch.inference_mode():
            logits = layers.gather_vocab(cfg, steps.last_logits(art.model, batch))
        out["prefill"].append({"token": np_tree(tok), "logits": np_tree(logits),
                               "collectives": colls})
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
