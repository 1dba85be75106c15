"""The benchmark of cinema_tpu_torch: run one cell with ``python3 -m perfbench.run`` (see run.py)."""
