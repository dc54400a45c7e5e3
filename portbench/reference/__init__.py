"""The plain reference of the benchmark's cells: the CogVideoX DiT and the
Diffusion-DPO LoRA step, in plain PyTorch.

Nothing here imports the program under test: the reference reads the raw
weights and inputs the benchmark made from the seed, and works out again
everything the program derives from them. It computes in float32 with TF32
off, or, as the control, with every matrix product's operands rounded to
float8 (e4m3, one scale a row).
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def float32_exact() -> Iterator[None]:
    """Float32 matrix products and convolutions in full float32: TF32 off
    in cuBLAS and cuDNN while the reference runs, whatever the program set,
    and as it was afterwards."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved
