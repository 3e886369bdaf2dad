"""ShardedDircIndex — multi-macro DIRC-RAG retrieval with incremental updates.

PyTorch counterpart of `repro.core.sharded_index`. The paper's system is
sixteen DIRC cores inside ONE macro (`topk.hierarchical_topk`); scaling
past one macro replicates the whole macro and splits the corpus across
macros:

  shard s  <->  one DIRC macro: its own per-document quantization scales,
                two's-complement bit-plane image, D-Sum LUT and
                integer-norm buffer. All shard images are stacked on a
                leading axis, e.g. planes (n_shards, capacity, bits, dim).

The macro axis is a batched leading dim (the JAX package's `vmap` and
`map` parallelism; both mean it here). Scoring is query-stationary, so the
stacked image is scored as ONE doc axis of n_shards * capacity rows — one
K1 or K2 launch per search on the kernel paths — and then reshaped to
(n_shards, b, capacity), dead slots at -inf.

`parallelism="shard_map"` spreads the macros over a device mesh
(`build(..., mesh=launch.mesh.make_macro_mesh())`; by default the macro
mesh over every rank of the process group): every rank holds the whole
image, scores its block of n_shards / ranks macros, and an all-gather
returns the (n_shards, b, capacity) scores to every rank, which then run
the same comparator tree. As in the reference, the kernel paths
(`kernel_bitserial`, `kernel_mxu`) and a mesh size that does not divide
n_shards take the `vmap` route instead, as does a process with no group.

Top-k is a three-level comparator tree: every core of every macro runs
its local comparator in one K4 launch (the (n_shards * b, capacity) rows
through `hierarchical_topk`), each macro merges its cores, and a cross-
macro global comparator sorts the small candidate list by (-score,
doc_id) — `jax.lax.top_k`'s lower-index tie-break, so a sharded search
equals a monolithic `DircRagIndex.search` (bit for bit on the integer
paths).

Incremental updates: `add_docs` writes each new document into a free slot
of the least-loaded macro (tombstones first; capacity doubles when every
macro is full) and `delete_docs` clears the slot's `alive` bit, a
tombstone. Global ids are never reused: `ids[s, slot]` maps slots to
stable ids.

Device physics (`config.error.enabled`): each macro has its own jittered
calibration and drift process (`device_physics.DevicePhysics`) and its
own remapping; sensing draws an independent channel per macro, from a
`torch.Generator` or from injected per-macro flip masks (the hook that
lets a test replay the JAX package's `fold_in(key, shard)` draws). The
Sigma-D counters feed `recalibration.RecalibrationController`, which
re-extracts and re-encodes a drifted macro online (`recalibrate_shard`).

Threads: searches and the recalibration poll run on the scheduler's
thread in a streaming pipeline. The index's tensors are created under
`torch.inference_mode()` and every method that writes them in place runs
in it, so grad mode (thread-local) never refuses a write.

The flat-index searcher over a mesh (`make_distributed_searcher`,
`shard_index_arrays`) is at the end of this module.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.spmd import (all_gather_axes, flat_index, local_shard, mesh_chips,
                              placements)
from . import (
    bitplane,
    device_physics,
    error_detection,
    error_model,
    quantization,
    remapping,
    topk,
)
from .device_physics import DevicePhysics, DriftConfig
from .retrieval import RetrievalConfig, score_image

PARALLELISM = ("vmap", "map", "shard_map")
_KERNEL_PATHS = ("kernel_bitserial", "kernel_mxu")   # shard_map takes the vmap route


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


@dataclasses.dataclass
class ShardedDircIndex:
    """Corpus partitioned over `n_shards` simulated DIRC macros.

    All per-shard tensors are stacked on a leading shard axis and padded
    to a common `capacity`; `alive` masks padding and tombstones, `ids`
    maps (shard, slot) to stable global document ids (-1 = never written).
    """

    config: RetrievalConfig
    n_shards: int
    capacity: int
    values: torch.Tensor        # (S, cap, dim) int8 codes
    scales: torch.Tensor        # (S, cap, 1) fp32 per-document scales
    planes: torch.Tensor        # (S, cap, bits, dim) uint8 {0,1}
    lut: torch.Tensor           # (S, cap, bits) int32 D-Sum LUT
    norms: torch.Tensor         # (S, cap) fp32 integer norms
    ids: torch.Tensor           # (S, cap) int32 global doc ids, -1 = empty
    alive: torch.Tensor         # (S, cap) bool
    mapping: np.ndarray         # (S, slots, bits, 3) PER-MACRO bit->cell maps
    flip_probs: torch.Tensor    # (S, slots, bits) fp32 TRUE channel probs
    dim: int
    next_id: int
    parallelism: str = "vmap"
    mesh: Optional[object] = None  # DeviceMesh (shard_map only)
    physics: Optional[DevicePhysics] = None  # ground-truth error channels
    believed_maps: Optional[np.ndarray] = None  # (S, 8, 8) maps each shard's
    #   remapping was extracted against; drifts from physics.true_map(s)

    def __post_init__(self) -> None:
        # Per-shard error/recal counters (host-side; tiny).
        #   cumulative: sense events, first-round Sigma-D detections,
        #     all-round detections, post-retry residual planes, recal
        #     events. window (reset by recalibrate_shard): per-(slot,
        #     bit) first-round detection counts, which `extract_error_map`
        #     inverts back into a spatial map.
        s = self.n_shards
        slots, bits = self.flip_probs.shape[1], self.flip_probs.shape[2]
        self._senses = np.zeros(s, np.int64)
        self._first_det = np.zeros(s, np.int64)
        self._detected = np.zeros(s, np.int64)
        self._residual = np.zeros(s, np.int64)
        self._recals = np.zeros(s, np.int64)
        self._win_senses = np.zeros(s, np.int64)
        self._win_det_map = np.zeros((s, slots, bits), np.int64)

    @property
    def device(self) -> torch.device:
        return self.planes.device

    # ---------------------------------------------------------------- build
    @classmethod
    @torch.inference_mode()
    def build(
        cls,
        embeddings,
        config: RetrievalConfig,
        n_shards: int = 4,
        parallelism: str = "vmap",
        mesh=None,
        drift: Optional[DriftConfig] = None,
        clock=None,
        device: DeviceLike = None,
    ) -> "ShardedDircIndex":
        """Split (n, dim) fp32 `embeddings` into `n_shards` contiguous
        macros on `device` (`None` is the card).

        `drift` / `clock` configure the per-macro `DevicePhysics` channel
        (only meaningful with `config.error.enabled`): each shard gets
        its own jittered calibration and drift process over the
        injectable clock, and, for `mapping="error_aware"`, its own
        remapping extracted against its own t=0 calibration.
        `parallelism="shard_map"` scores the macros over `mesh` (a
        `DeviceMesh`; None: the macro mesh over every rank of the process
        group, or one device without a group); every rank builds the
        same index from the same embeddings."""
        if parallelism not in PARALLELISM:
            raise ValueError(f"parallelism must be one of {PARALLELISM}")
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        dev = resolve_device(device)
        if parallelism == "shard_map" and mesh is None and dist.is_initialized():
            # the mesh `launch.mesh.make_macro_mesh` builds
            mesh = init_device_mesh(dev.type, (dist.get_world_size(),),
                                    mesh_dim_names=("macro",))
        emb = _as_numpy(embeddings)
        n, dim = emb.shape
        chunks = np.array_split(np.arange(n), n_shards)  # contiguous shards
        cap = max(1, max(len(c) for c in chunks))
        stacked = np.zeros((n_shards, cap, dim), np.float32)
        ids = np.full((n_shards, cap), -1, np.int32)
        alive = np.zeros((n_shards, cap), bool)
        for s, c in enumerate(chunks):
            stacked[s, : len(c)] = emb[c]
            ids[s, : len(c)] = c
            alive[s, : len(c)] = True

        docs = quantization.quantize(torch.as_tensor(stacked, device=dev),
                                     bits=config.bits, per_row=True)
        planes = bitplane.to_bitplanes(docs.values, bits=config.bits)
        physics = None
        believed = None
        if config.error.enabled:
            # One error channel PER macro; each shard's remapping is
            # extracted against its own t=0 calibration (a perfect
            # extraction; drift then degrades it).
            physics = DevicePhysics(config.error, n_shards, drift=drift, clock=clock)
            believed = physics.true_maps()
            mapping = np.stack([
                remapping.build_mapping_for_map(
                    config.mapping, config.bits,
                    believed[s] if config.mapping == "error_aware" else None)
                for s in range(n_shards)
            ])
            probs = physics.flip_probs(mapping)
        else:
            base = remapping.build_mapping(config.mapping, bits=config.bits,
                                           error_cfg=config.error)
            mapping = device_physics.stack_mappings(base, n_shards)
            probs = np.broadcast_to(
                error_model.flip_probs_for_mapping(base, config.error),
                mapping.shape[:3])
        return cls(
            config=config,
            n_shards=n_shards,
            capacity=cap,
            values=docs.values,
            scales=docs.scale,
            planes=planes,
            lut=bitplane.sum_d_lut(planes),
            norms=quantization.doc_int_norms(docs),
            ids=torch.as_tensor(ids, device=dev),
            alive=torch.as_tensor(alive, device=dev),
            mapping=mapping,
            flip_probs=torch.as_tensor(np.array(probs), dtype=torch.float32,
                                       device=dev),
            dim=dim,
            next_id=n,
            parallelism=parallelism,
            mesh=mesh,
            physics=physics,
            believed_maps=believed,
        )

    # ------------------------------------------------------------- counters
    @property
    def n_docs(self) -> int:
        """Live (non-tombstoned) documents across all shards."""
        return int(self.alive.sum())

    def shard_loads(self) -> np.ndarray:
        """(S,) live docs per shard — the add_docs balancing signal."""
        return self.alive.sum(dim=1).cpu().numpy()

    def _rows_per_slot(self) -> np.ndarray:
        """(slots,) how many rows of a shard land on each physical slot
        (row -> slot is `row % n_slots`, see `apply_sense_errors`)."""
        n_slots = self.mapping.shape[1]
        return np.bincount(np.arange(self.capacity) % n_slots, minlength=n_slots)

    def stats(self) -> dict:
        """Per-shard error/recalibration counters + fleet rollup.

        `detected_rate` is first-round detections over first-round plane
        trials, an unbiased estimate of the channel's plane-mismatch
        probability. `exposure` is the ground-truth weighted error mass
        under the CURRENT mapping (what recalibration drives back down);
        `drift_amplitude`/`drift_phase` are simulation ground truth for
        reports, invisible to the controller.
        """
        plane_trials = self.capacity * self.config.bits
        shards = []
        for s in range(self.n_shards):
            senses = int(self._senses[s])
            trials = max(senses * plane_trials, 1)
            row = {
                "senses": senses,
                "detected": int(self._detected[s]),
                "residual": int(self._residual[s]),
                "detected_rate": float(self._first_det[s] / trials),
                "residual_rate": float(self._residual[s] / trials),
                "recal_events": int(self._recals[s]),
            }
            if self.physics is not None:
                row["drift_amplitude"] = float(self.physics.drift_amplitude()[s])
                row["drift_phase"] = float(self.physics.drift_phase()[s])
                row["exposure"] = device_physics.weighted_exposure(
                    self.mapping[s], self.physics.true_map(s))
            shards.append(row)
        return {
            "n_shards": self.n_shards,
            "capacity": self.capacity,
            "live_docs": self.n_docs,
            "error_enabled": bool(self.config.error.enabled),
            "drift_enabled": bool(
                self.physics is not None and self.physics.drift.enabled),
            "total_senses": int(self._senses.sum()),
            "total_detected": int(self._detected.sum()),
            "total_residual": int(self._residual.sum()),
            "total_recals": int(self._recals.sum()),
            "shards": shards,
        }

    # ---------------------------------------------------------------- sense
    def _channel_probs(self) -> torch.Tensor:
        """The TRUE per-(slot, bit) probabilities under the current
        mappings, as a tensor on the index's device."""
        return torch.as_tensor(self.physics.flip_probs(self.mapping),
                               dtype=torch.float32, device=self.device)

    def _refresh_channel(self) -> None:
        """Advance the drift processes to the clock and resample the TRUE
        per-(slot, bit) probabilities under the current mappings. The
        believed maps / mappings are left alone — that gap is the point.
        """
        if self.physics is None or not self.physics.drift.enabled:
            return
        self.physics.advance()
        self.flip_probs = self._channel_probs()

    def _sensed_planes(
        self, generator: Optional[torch.Generator] = None,
        flips: Optional[Sequence[Sequence[torch.Tensor]]] = None,
    ) -> torch.Tensor:
        """Per-query transient sensing, one independent channel per macro.

        Shard s draws its rounds from `generator` (on the index's device),
        after shard s-1, or replays `flips[s]` (one mask per sensing
        round, as `error_detection.sense_with_detection` takes them); with
        neither the planes are clean, as a `None` key is in the JAX
        package. Folds the per-shard Sigma-D counters into the stats."""
        cfg = self.config
        if not cfg.error.enabled or (generator is None and flips is None):
            return self.planes
        if flips is not None and len(flips) != self.n_shards:
            raise ValueError(f"flips holds {len(flips)} shards, the index {self.n_shards}")
        self._refresh_channel()
        retries = cfg.max_retries if cfg.detect else 0
        results = [
            error_detection.sense_with_detection(
                self.planes[s], self.lut[s], self.flip_probs[s], generator,
                max_retries=retries, detect=cfg.detect,
                flips=None if flips is None else flips[s])
            for s in range(self.n_shards)
        ]
        dmap = torch.stack([r.detected_map for r in results]).cpu().numpy().astype(np.int64)
        self._senses += 1
        self._first_det += dmap.sum(axis=(1, 2))
        self._detected += np.array([int(r.detected) for r in results], np.int64)
        self._residual += np.array([int(r.residual_planes) for r in results], np.int64)
        self._win_senses += 1
        self._win_det_map += dmap
        return torch.stack([r.planes for r in results])

    # ---------------------------------------------------------------- score
    def _macro_block(self) -> Optional[tuple[int, int]]:
        """[lo, hi): the block of macros this rank scores on the shard_map
        route, by its row-major place in the mesh; None on the vmap route
        (every macro scored here): without `shard_map` or a mesh, on a
        kernel path, or where the mesh size does not divide n_shards."""
        S = self.n_shards
        if (self.parallelism != "shard_map" or self.mesh is None
                or self.config.path in _KERNEL_PATHS or S % mesh_chips(self.mesh)):
            return None
        per = S // mesh_chips(self.mesh)
        i = flat_index(self.mesh, self.mesh.mesh_dim_names)
        return i * per, (i + 1) * per

    def scores(self, queries, generator: Optional[torch.Generator] = None,
               flips: Optional[Sequence[Sequence[torch.Tensor]]] = None) -> torch.Tensor:
        """(b, dim) fp32 queries -> (S, b, cap) per-macro scores; dead slots
        (padding/tombstones) are -inf."""
        cfg = self.config
        queries = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        if queries.ndim == 1:
            queries = queries[None]
        # Same sensing gate as DircRagIndex.scores: the reference path
        # never reads planes, so it pays no per-shard sense/detect loop.
        uses_planes = cfg.path in (
            "bitserial", "kernel_bitserial", "kernel_mxu"
        ) or (cfg.path == "int_exact" and cfg.error.enabled)
        planes = self._sensed_planes(generator, flips) if uses_planes else self.planes
        S, cap = self.n_shards, self.capacity
        block = self._macro_block()
        lo, hi = block or (0, S)
        rows = (hi - lo) * cap
        q = quantization.quantize_query(queries, bits=cfg.bits)
        # query-stationary: the block's images scored as one doc axis
        s = score_image(cfg, q, queries, self.values[lo:hi].reshape(rows, self.dim),
                        self.scales[lo:hi].reshape(rows, 1),
                        planes[lo:hi].reshape(rows, cfg.bits, self.dim),
                        self.norms[lo:hi].reshape(rows))
        s = s.reshape(queries.shape[0], hi - lo, cap).permute(1, 0, 2)
        if block is not None:   # every rank's block, in mesh order
            s = all_gather_axes(s, self.mesh, self.mesh.mesh_dim_names)
        return torch.where(self.alive[:, None, :], s, float("-inf"))

    # --------------------------------------------------------------- search
    def search(self, queries, k: int, generator: Optional[torch.Generator] = None,
               flips: Optional[Sequence[Sequence[torch.Tensor]]] = None) -> topk.TopK:
        """Three-level comparator tree: cores -> macro -> global merge.

        Returns global doc ids; id -1 marks "fewer than k live documents".
        """
        if k > self.n_shards * self.capacity:
            raise ValueError(f"k={k} exceeds total slots {self.n_shards * self.capacity}")
        s = self.scores(queries, generator=generator, flips=flips)    # (S, b, cap)
        S, b, cap = s.shape
        kk = min(k, cap)
        flat = s.reshape(S * b, cap)
        n_cores = self.config.n_cores
        # per-macro top-k: the 16-core comparator tree when the capacity
        # folds (every core of every macro in one K4 launch)
        per_shard = (topk.hierarchical_topk(flat, kk, n_cores=n_cores)
                     if cap % n_cores == 0 else topk.local_topk(flat, kk))
        lv = per_shard.scores.reshape(S, b, kk)
        li = per_shard.indices.long().reshape(S, b, kk)
        # slot -> stable global id; dead slots surface as -1
        masked_ids = torch.where(self.alive, self.ids, -1)                # (S, cap)
        gid = torch.gather(masked_ids[:, None, :].expand(S, b, cap), 2, li)
        cand_v = lv.permute(1, 0, 2).reshape(b, S * kk)
        cand_i = gid.permute(1, 0, 2).reshape(b, S * kk)
        # Global comparator: (-score, id) order is jax.lax.top_k's
        # lower-index tie-break over a monolithic score row.
        merged = topk.merge_candidates(cand_v, cand_i, k)
        return topk.TopK(scores=merged.scores, indices=merged.indices.int())

    # --------------------------------------------------------------- update
    @torch.inference_mode()
    def _grow(self, extra: int) -> None:
        """Double capacity (at least `extra` new slots/shard) by padding."""
        new_cap = max(self.capacity * 2, self.capacity + extra)
        pad = new_cap - self.capacity

        def pad1(x: torch.Tensor, value=0) -> torch.Tensor:
            tail = torch.full((x.shape[0], pad, *x.shape[2:]), value,
                              dtype=x.dtype, device=x.device)
            return torch.cat([x, tail], dim=1)

        self.values = pad1(self.values)
        self.scales = pad1(self.scales.float(), 1.0)
        self.planes = pad1(self.planes)
        self.lut = pad1(self.lut)
        self.norms = pad1(self.norms)
        self.ids = pad1(self.ids, -1)
        self.alive = pad1(self.alive, False)
        self.capacity = new_cap

    @torch.inference_mode()
    def add_docs(self, embeddings) -> np.ndarray:
        """Write new documents into the least-loaded macros, in place.

        Each row is quantized per-macro-row (scale, planes, LUT entry and
        norm for its slot) and written to the shard with the fewest live
        documents, reusing tombstoned slots first. Returns the new stable
        global ids, (m,) int32.
        """
        emb = np.atleast_2d(_as_numpy(embeddings))
        m = emb.shape[0]
        if emb.shape[1] != self.dim:
            raise ValueError(f"dim mismatch: got {emb.shape[1]}, want {self.dim}")

        loads = self.shard_loads().astype(np.int64)
        free = self.capacity - loads
        # Greedy balance on the host: always the least-loaded shard with a
        # free slot; grow every shard when the whole macro set is full.
        targets = np.empty((m,), np.int64)
        for j in range(m):
            open_shards = np.flatnonzero(free > 0)
            if open_shards.size == 0:
                self._grow(1)
                free = self.capacity - loads
                open_shards = np.flatnonzero(free > 0)
            s = open_shards[np.argmin(loads[open_shards])]
            targets[j] = s
            loads[s] += 1
            free[s] -= 1

        # One free slot per assignment, in target order (reuse tombstones).
        alive = self.alive.cpu().numpy().copy()
        slots = np.empty((m,), np.int64)
        cursor: dict[int, int] = {}
        for j, s in enumerate(targets):
            start = cursor.get(s, 0)
            dead = np.flatnonzero(~alive[s, start:])
            slot = start + int(dead[0])
            slots[j] = slot
            alive[s, slot] = True
            cursor[s] = slot + 1

        dev = self.device
        docs = quantization.quantize(torch.as_tensor(emb, device=dev),
                                     bits=self.config.bits, per_row=True)
        new_planes = bitplane.to_bitplanes(docs.values, bits=self.config.bits)
        t = torch.as_tensor(targets, device=dev)
        sl = torch.as_tensor(slots, device=dev)
        new_ids = np.arange(self.next_id, self.next_id + m, dtype=np.int32)
        self.values[t, sl] = docs.values
        self.scales[t, sl] = docs.scale
        self.planes[t, sl] = new_planes
        self.lut[t, sl] = bitplane.sum_d_lut(new_planes)
        self.norms[t, sl] = quantization.doc_int_norms(docs)
        self.ids[t, sl] = torch.as_tensor(new_ids, device=dev)
        self.alive[t, sl] = True
        self.next_id += m
        return new_ids

    @torch.inference_mode()
    def delete_docs(self, doc_ids: Sequence[int]) -> int:
        """Tombstone documents by stable global id. Returns #deleted.

        The image is untouched (a real macro would not erase cells); only
        the alive bit flips, so the slot is masked out of every later
        search and becomes reusable by `add_docs`.
        """
        targets = torch.as_tensor(np.asarray(list(doc_ids), np.int32), device=self.device)
        hit = torch.isin(self.ids, targets) & self.alive
        n = int(hit.sum())
        self.alive = self.alive & ~hit
        return n

    # -------------------------------------------------------- recalibration
    def extract_error_map(self, shard: int) -> np.ndarray:
        """(8, 8) believed LSB map of one macro from its detection window.

        Inverts the since-last-recal first-round Sigma-D mismatch counts
        (per physical slot/bit) back into per-cell flip probabilities and
        scatters them through the shard's CURRENT mapping — the online
        analogue of the paper's offline Monte-Carlo map extraction.
        """
        trials = self._rows_per_slot() * max(int(self._win_senses[shard]), 1)
        return device_physics.extract_map_from_counts(
            self.mapping[shard], self._win_det_map[shard], trials, self.dim)

    @torch.inference_mode()
    def recalibrate_shard(self, shard: int, believed_map: Optional[np.ndarray] = None,
                          chunk_rows: Optional[int] = None, on_chunk=None) -> np.ndarray:
        """Re-extract one macro's map, re-run remapping, re-encode in place.

        The index stays ONLINE throughout: the re-encode walks the shard's
        rows in chunks of `chunk_rows` (default capacity/4), rewriting
        planes + D-Sum LUT from the stored int8 codes — logical bit-plane
        content is mapping-invariant, so searches interleaved between
        chunks (`on_chunk(lo, hi)`) keep returning correct top-k. The
        mapping / channel-probability swap at the end is one host-side
        assignment.

        Returns the believed map the new remapping was extracted against.
        Resets the shard's detection window, so the controller baselines
        afresh against the post-recal channel.
        """
        cfg = self.config
        emap = (np.asarray(believed_map, np.float64) if believed_map is not None
                else self.extract_error_map(shard))
        new_mapping = remapping.build_mapping_for_map(
            cfg.mapping, cfg.bits, emap if cfg.mapping == "error_aware" else None)

        step = chunk_rows or max(1, self.capacity // 4)
        for lo in range(0, self.capacity, step):
            hi = min(lo + step, self.capacity)
            chunk = bitplane.to_bitplanes(self.values[shard, lo:hi], bits=cfg.bits)
            self.planes[shard, lo:hi] = chunk
            self.lut[shard, lo:hi] = bitplane.sum_d_lut(chunk)
            if on_chunk is not None:
                on_chunk(lo, hi)

        new_mappings = np.array(self.mapping)
        new_mappings[shard] = new_mapping
        self.mapping = new_mappings
        if self.believed_maps is not None:
            self.believed_maps = np.array(self.believed_maps)
            self.believed_maps[shard] = emap
        if self.physics is not None:
            self.flip_probs = self._channel_probs()
        self._win_det_map[shard] = 0
        self._win_senses[shard] = 0
        self._recals[shard] += 1
        return emap

    # --------------------------------------------------------------- memory
    def storage_bytes(self) -> dict:
        """Per-macro ReRAM image + buffer, summed over allocated slots."""
        slots = self.n_shards * self.capacity
        emb = slots * self.dim * self.config.bits // 8
        buffer = slots * (4 + 4 + self.config.bits * 4 // 8)
        return {"embeddings": emb, "reram_buffer": buffer, "live_docs": self.n_docs}


# --------------------------------------------------------------------------
# The pod-scale flat-index searcher. `ShardedDircIndex` stacks per-macro
# IMAGES; this is the complementary flat layout: one (n, dim) int8 code
# matrix split along its doc axis over the mesh, scored with the paper's
# comparator dataflow in collectives:
#
#     doc shard per rank (query-stationary: docs never move)
#       -> per-rank INT8 scores (K2)             (local, no collective)
#       -> per-rank local top-k (K4)             (the "local comparator")
#       -> all-gather of (score, id) candidates  (the "SRAM buffer": tiny)
#       -> global top-k (K4)                     (the "global comparator")
# --------------------------------------------------------------------------

def _top_k(scores: torch.Tensor, k: int) -> topk.TopK:
    """`lax.top_k` of each row (value descending, lower position first
    among equal values, XLA's float order): one launch of K4's fused
    selection on the card, over 16 cores where the row folds."""
    return topk.hierarchical_topk(scores, k, n_cores=16 if scores.shape[-1] % 16 == 0 else 1)


def _doc_axes(mesh, doc_axes) -> tuple:
    return tuple(doc_axes) if doc_axes is not None else tuple(mesh.mesh_dim_names)


def _check_divides(n: int, mesh, axes: tuple) -> None:
    """The doc axis splits evenly over `axes`, as the reference's
    `shard_map` demands: global ids are `local + shard * n_local`."""
    chips = mesh_chips(mesh, axes)
    if n % chips:
        raise ValueError(f"{n} docs do not divide over the {chips} ranks of mesh "
                         f"axes {axes}")


def _local(x: torch.Tensor, mesh, axes: tuple) -> torch.Tensor:
    """This rank's doc shard: a DTensor's local block, or the block of a
    whole tensor that every rank holds."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.to_local()
    return local_shard(x, mesh, placements((axes,), mesh))


def make_distributed_searcher(mesh, k: int, metric: str = "cosine", doc_axes=None):
    """A flat-index searcher over `mesh` (a `DeviceMesh`): docs split along
    their first axis over `doc_axes` (default: every mesh dim, in mesh
    order: every rank holds a distinct shard), queries replicated.

    Returns fn(q int8 (b, dim), docs int8 (n, dim), norms (n,)) -> TopK of
    (b, k) scores and global doc ids, the same on every rank; docs and
    norms are `shard_index_arrays`' DTensors, or whole tensors of which
    each rank scores its block; n must divide over the doc axes' ranks
    (ValueError otherwise, as the reference's `shard_map` refuses it).
    Cosine scores are `ip / max(qn * dn, 1e-12)` with ip K2's exact int32
    dot and qn the fp32 root of the query codes' fp32 sum of squares, the
    reference's arithmetic; "mips" is ip. Every rank of the mesh calls fn
    together."""
    if metric not in ("cosine", "mips"):
        raise ValueError(f"unknown metric {metric!r}")
    axes = _doc_axes(mesh, doc_axes)
    shard = flat_index(mesh, axes)

    def search(q: torch.Tensor, docs: torch.Tensor, norms: torch.Tensor) -> topk.TopK:
        from repro_torch.kernels import ops as kops

        _check_divides(docs.shape[0], mesh, axes)
        d = _local(docs, mesh, axes)
        ip = kops.score_matmul(q, d).float()                      # (b, n_local)
        if metric == "cosine":
            qn = torch.sqrt(torch.sum(q.float() ** 2, dim=-1, keepdim=True))
            dn = _local(norms, mesh, axes).float()
            ip = ip / torch.clamp_min(qn * dn[None, :], 1e-12)
        n_local = d.shape[0]
        local = _top_k(ip, min(k, n_local))
        gid = local.indices + shard * n_local                     # global doc ids
        cand_v = all_gather_axes(local.scores, mesh, axes, dim=1)  # (b, P * kk)
        cand_i = all_gather_axes(gid, mesh, axes, dim=1)
        best = _top_k(cand_v, k)
        return topk.TopK(scores=best.scores,
                         indices=torch.gather(cand_i, 1, best.indices.long()))

    return search


def shard_index_arrays(mesh, docs_values, doc_norms, doc_axes=None):
    """Place flat-index arrays as the searcher expects: DTensors split
    along the doc axis over `doc_axes`, replicated over the other dims.
    Every rank passes the same whole arrays and keeps its block (no
    collective); n must divide over the doc axes' ranks (ValueError)."""
    from torch.distributed.tensor import DTensor

    axes = _doc_axes(mesh, doc_axes)
    _check_divides(docs_values.shape[0], mesh, axes)
    place = placements((axes,), mesh)
    return tuple(DTensor.from_local(local_shard(x, mesh, place).contiguous(), mesh, place)
                 for x in (docs_values, doc_norms))
