"""Model families ported so far: CogVideoX."""
