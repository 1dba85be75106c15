"""Inference examples (port of the JAX package's ``examples/inference``): segmentation, classification,
regression, landmarks and the MAE, from local safetensors weights and their config.yaml."""
