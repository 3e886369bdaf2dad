"""repro_torch.kernels — the ported TPU kernels, each a CUDA C++ kernel
for Hopper (`csrc/`) beside its plain PyTorch version:

  K1 `dirc_mac.dirc_mac_packed`       <- repro.kernels.dirc_mac
  K2 `score_matmul.score_matmul_int`  <- repro.kernels.score_matmul
  K3 `paged_attend.paged_attend_fused` <- repro.kernels.paged_attend
  K4 `topk_select.blockwise_topk`     <- repro.kernels.topk_select
     (and `topk_select.hierarchical_select`: K4 plus the global comparator)
  K5 `score_matmul.score_matmul_cosine` <- repro.kernels.score_matmul

`_build` compiles `csrc/*.cu` with nvcc at first use. Nothing CUDA is
touched at import time. `counters` reads and resets the wrappers' launch
counts under the lock every increment takes.
"""
from . import ops, paged_attend, ref  # noqa: F401
