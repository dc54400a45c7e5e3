"""Training-side pieces ported so far: the DiT's LoRA hook."""
