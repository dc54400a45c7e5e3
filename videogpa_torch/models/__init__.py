"""Model families of the port: CogVideoX, T5, Wan2.2, VGGT, LPIPS and DA3."""
