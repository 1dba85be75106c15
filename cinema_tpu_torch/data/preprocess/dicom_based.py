"""DICOM-sourced preprocessing entry points: Kaggle DSB, rescan, UKB (port of
cinema_tpu/data/preprocess/dicom_based.py).

The JAX package's console-script shims (``kaggle_preprocess``, ``rescan_preprocess``, ``dicom_to_nifti``)
over the full pipelines, which are built on the pure-Python DICOM reader
(cinema_tpu_torch.data.dicom) and the oriented-volume toolkit
(cinema_tpu_torch.data.volume):

- cinema_tpu_torch.data.preprocess.kaggle  (reference cinema/data/kaggle/preprocess.py)
- cinema_tpu_torch.data.preprocess.rescan  (reference cinema/data/rescan/preprocess.py)
- cinema_tpu_torch.data.preprocess.ukb_dicom (reference cinema/examples/dicom_to_nifti.py)
"""

from __future__ import annotations

from cinema_tpu_torch.data.preprocess.kaggle import main as main_kaggle
from cinema_tpu_torch.data.preprocess.rescan import main as main_rescan
from cinema_tpu_torch.data.preprocess.ukb_dicom import main as main_dicom_to_nifti

__all__ = ["main_kaggle", "main_rescan", "main_dicom_to_nifti"]
