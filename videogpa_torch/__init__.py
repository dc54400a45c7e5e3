"""VideoGPA in PyTorch for NVIDIA Hopper (H100): the port of ``videogpa_tpu``.

The JAX package ``videogpa_tpu`` is the reference; this package keeps its
module names so each function has an obvious counterpart:

- ``videogpa_torch.ops``      — layers, RoPE, resize, the ViT block, attention
  (hand-written CUDA kernels K1, K3, K4, K6, K7 and the int8-QK K8, K9), W8A8
  quantised linears (``ops.quant``)
- ``videogpa_torch.models``   — CogVideoX DiT, scheduler, denoise loop; Wan2.2
  DiT, flow matching, TI2V denoise loop; VGGT; LPIPS
- ``videogpa_torch.train``    — LoRA, the DPO loss, the CogVideoX and Wan
  train steps, dataset
- ``videogpa_torch.geometry`` — poses, unprojection, z-buffer reprojection
  (hand-written CUDA scatter-min K5)
- ``videogpa_torch.metrics``  — the scorer's metric functions and classes
- ``videogpa_torch.reward``   — the VGGT reward scorer (``VideoProcessor``)
- ``videogpa_torch.convert``  — JAX parameter tree -> module state
- ``videogpa_torch.parallel`` — data, tensor and sequence parallelism on
  ``torch.distributed`` (mesh, sharding rules; ring attention in ``ops``)

It imports neither ``jax`` nor ``videogpa_tpu``. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; CPU tensors take the plain PyTorch
version of each kernel, CUDA tensors launch the kernel or raise.
"""

from videogpa_torch.device import resolve_device

__all__ = ["resolve_device"]
