"""Training: optimizer, train state and step, checkpoints (port of cinema_tpu/train)."""
