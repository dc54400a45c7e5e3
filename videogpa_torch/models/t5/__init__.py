"""T5 text encoder family (T5-v1.1 XXL for CogVideoX, umT5-XXL for Wan)."""

from videogpa_torch.models.t5.encoder import (
    T5Config,
    T5Encoder,
    convert_t5_encoder,
    t5_encode,
    t5_encoder_init,
)

__all__ = ["T5Config", "T5Encoder", "t5_encoder_init", "t5_encode", "convert_t5_encoder"]
