"""repro_torch.kernels — the ported TPU kernels, each a CUDA C++ kernel
for Hopper (`csrc/`) beside its plain PyTorch version:

  K1 `dirc_mac.dirc_mac_packed`       <- repro.kernels.dirc_mac
  K2 `score_matmul.score_matmul_int`  <- repro.kernels.score_matmul

`_build` compiles `csrc/*.cu` with nvcc at first use. Nothing CUDA is
touched at import time.
"""
