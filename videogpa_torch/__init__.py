"""VideoGPA in PyTorch for NVIDIA Hopper (H100): the port of ``videogpa_tpu``.

The JAX package ``videogpa_tpu`` is the reference; this package keeps its
module names so each function has an obvious counterpart:

- ``videogpa_torch.ops``     — layers, RoPE, attention (hand-written CUDA kernel)
- ``videogpa_torch.models``  — CogVideoX DiT, scheduler, denoise loop
- ``videogpa_torch.train``   — LoRA hook of the DiT
- ``videogpa_torch.convert`` — JAX parameter tree -> module state

It imports neither ``jax`` nor ``videogpa_tpu``. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; CPU tensors take the plain PyTorch
version of each kernel, CUDA tensors launch the kernel or raise.
"""

from videogpa_torch.device import resolve_device

__all__ = ["resolve_device"]
