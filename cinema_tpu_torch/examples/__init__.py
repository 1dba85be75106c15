"""The example scripts of the port (port of the JAX package's ``examples/``): inference with finetuned and
pretrained models (``examples.inference``) and self-contained training loops (``examples.train``), each run
as ``python -m cinema_tpu_torch.examples.<inference|train>.<name>`` and callable as ``main(argv)``."""
