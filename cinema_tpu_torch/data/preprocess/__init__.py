"""The offline preprocessing CLIs (port of cinema_tpu/data/preprocess; reference cinema/data/*/preprocess.py).

Raw challenge downloads, Kaggle and UKB DICOM and rescan pickles become the resampled, LV-centred,
intensity-normalised uint8 NIfTI folders and metadata tables that the task datasets read. Host code in numpy,
scipy, ``csv``, ``struct`` and ``zlib``: no pandas, no PIL, nothing on the card. Each CLI runs as
``python -m cinema_tpu_torch.data.preprocess.<name>`` with the JAX script's flags and writes what it writes.
"""
