"""DircRagIndex — the end-to-end DIRC-RAG retrieval engine.

PyTorch counterpart of `repro.core.retrieval`.

Build: FP32 corpus embeddings -> per-row symmetric INT8/INT4 quantization
-> two's-complement bit-planes (the ReRAM image) -> D-Sum LUT + integer
norms (the ReRAM buffer) -> error-aware bit mapping.

Search: query FP32 -> quantize -> (optionally error-injected, checksum
re-sensed) bit-serial MAC or GEMM scores -> cosine/MIPS -> hierarchical
local/global top-k.

Compute paths:
  reference        fp32 dequantized matmul (oracle; no hardware semantics)
  int_exact        exact integer dot product (what error-free DIRC computes)
  bitserial        functional bit-plane MAC (paper Fig. 4) + error channel
  kernel_bitserial K1, the CUDA bit-plane MAC (`kernels.dirc_mac`)
  kernel_mxu       K2, the CUDA INT8 GEMM (`kernels.score_matmul`)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from . import bitplane, error_detection, error_model, quantization, remapping, topk

PATHS = ("reference", "int_exact", "bitserial", "kernel_bitserial", "kernel_mxu")


def score_image(
    config: "RetrievalConfig",
    q: quantization.QuantizedTensor,
    queries_f32: torch.Tensor,
    values: torch.Tensor,      # (n, dim) int8 codes
    scales: torch.Tensor,      # (n, 1) or () fp32 quantization scales
    planes: torch.Tensor,      # (n, bits, dim) uint8 {0,1}, already sensed
    norms: torch.Tensor,       # (n,) fp32 integer norms
) -> torch.Tensor:
    """Score one ReRAM image: (b, n) fp32 under `config.path`/`metric`."""
    if config.metric not in ("cosine", "mips"):
        raise ValueError(f"unknown metric {config.metric!r}")
    if config.path == "reference":
        d = values.float() * scales
        qf = queries_f32.float()
        ip = qf @ d.T
        if config.metric == "cosine":
            qn = torch.linalg.vector_norm(qf, dim=-1, keepdim=True)
            dn = torch.linalg.vector_norm(d, dim=-1)
            return ip / torch.clamp_min(qn * dn, 1e-12)
        return ip

    if config.path == "int_exact" and not config.error.enabled:
        ip = quantization.int_inner_product(q.values, values)
    elif config.path in ("bitserial", "int_exact"):
        ip = bitplane.bitserial_dot(q.values, planes, bits=config.bits)
    elif config.path == "kernel_bitserial":
        from repro_torch.kernels import ops as kops

        packed = bitplane.pack_words(planes)
        ip = kops.dirc_mac(q.values, packed, bits=config.bits)
    elif config.path == "kernel_mxu":
        from repro_torch.kernels import ops as kops

        vals = bitplane.from_bitplanes(planes, bits=config.bits)
        ip = kops.score_matmul(q.values, vals)
    else:
        raise ValueError(f"unknown path {config.path!r}")

    ip = ip.float()
    if config.metric == "mips":
        d_scale = scales.reshape(-1) if scales.ndim else scales
        return ip * q.scale * d_scale
    qn = quantization.int_norm(q.values, keepdim=True)
    return ip / torch.clamp_min(qn * norms, 1e-12)


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    bits: int = 8
    metric: str = "cosine"            # "cosine" | "mips"
    n_cores: int = 16
    path: str = "int_exact"
    mapping: str = "error_aware"      # remapping.STRATEGIES
    error: error_model.ErrorModelConfig = dataclasses.field(
        default_factory=error_model.ErrorModelConfig
    )
    detect: bool = True               # Sigma-D checksum + re-sense
    max_retries: int = 3


@dataclasses.dataclass
class DircRagIndex:
    config: RetrievalConfig
    docs: quantization.QuantizedTensor          # (n, dim) int codes + scales
    planes: torch.Tensor                        # (n, bits, dim) uint8 {0,1}
    lut: torch.Tensor                           # (n, bits) int32 D-Sum LUT
    doc_norms: torch.Tensor                     # (n,) fp32 integer norms
    mapping: np.ndarray                         # (slots, bits, 3)
    flip_probs: torch.Tensor                    # (slots, bits) fp32
    n_docs: int
    dim: int

    @property
    def device(self) -> torch.device:
        return self.planes.device

    # ---------------------------------------------------------------- build
    @classmethod
    def build(cls, embeddings, config: RetrievalConfig,
              device: DeviceLike = None) -> "DircRagIndex":
        """embeddings: (n, dim) fp32 array or tensor; `device=None` is the card."""
        dev = resolve_device(device)
        embeddings = torch.as_tensor(embeddings, dtype=torch.float32, device=dev)
        n, dim = embeddings.shape
        docs = quantization.quantize(embeddings, bits=config.bits, per_row=True)
        planes = bitplane.to_bitplanes(docs.values, bits=config.bits)
        lut = bitplane.sum_d_lut(planes)
        norms = quantization.doc_int_norms(docs)
        mapping = remapping.build_mapping(
            config.mapping, bits=config.bits, error_cfg=config.error
        )
        probs = torch.as_tensor(
            error_model.flip_probs_for_mapping(mapping, config.error),
            dtype=torch.float32, device=dev,
        )
        return cls(config=config, docs=docs, planes=planes, lut=lut,
                   doc_norms=norms, mapping=mapping, flip_probs=probs,
                   n_docs=n, dim=dim)

    # ---------------------------------------------------------------- sense
    def sensed_planes(
        self, generator: Optional[torch.Generator] = None,
        flips: Optional[Sequence[torch.Tensor]] = None,
    ) -> tuple[torch.Tensor, dict]:
        """Apply the per-query transient sensing channel (+ detection).

        Draws from `generator` (on the index's device) or replays `flips`
        (one mask per sensing round); with neither the planes are clean,
        as a `None` key is in the JAX package."""
        cfg = self.config
        if not cfg.error.enabled or (generator is None and flips is None):
            return self.planes, {"detected": 0, "residual": 0}
        res = error_detection.sense_with_detection(
            self.planes, self.lut, self.flip_probs, generator,
            max_retries=cfg.max_retries if cfg.detect else 0,
            detect=cfg.detect, flips=flips,
        )
        stats = {"detected": int(res.detected), "residual": int(res.residual_planes)}
        return res.planes, stats

    # ---------------------------------------------------------------- score
    def scores(self, queries, generator: Optional[torch.Generator] = None,
               flips: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """(b, dim) fp32 queries -> (b, n_docs) similarity scores."""
        cfg = self.config
        queries = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        if queries.ndim == 1:
            queries = queries[None]
        q = quantization.quantize_query(queries, bits=cfg.bits)
        # Sensing (the error channel) only touches the bit-plane paths.
        uses_planes = cfg.path in (
            "bitserial", "kernel_bitserial", "kernel_mxu"
        ) or (cfg.path == "int_exact" and cfg.error.enabled)
        planes = (self.sensed_planes(generator, flips)[0] if uses_planes
                  else self.planes)
        return score_image(cfg, q, queries, self.docs.values, self.docs.scale,
                           planes, self.doc_norms)

    # --------------------------------------------------------------- search
    def search(self, queries, k: int,
               generator: Optional[torch.Generator] = None,
               flips: Optional[Sequence[torch.Tensor]] = None) -> topk.TopK:
        s = self.scores(queries, generator=generator, flips=flips)
        n_cores = self.config.n_cores
        if self.n_docs % n_cores:
            return topk.local_topk(s, k)  # ragged db: single comparator
        return topk.hierarchical_topk(s, k, n_cores=n_cores)

    # ------------------------------------------------------------- memory
    def storage_bytes(self) -> dict:
        """ReRAM image + buffer sizes (what Table II's 'Embedding Size' is)."""
        emb = self.n_docs * self.dim * self.config.bits // 8
        buffer = self.n_docs * (4 + 4 + self.config.bits * 4 // 8)
        return {"embeddings": emb, "reram_buffer": buffer}
