"""The port's data engine (port of cinema_tpu/data): the NIfTI reader and writer (``nifti``), the
augmentation transforms (``transforms``), and the datasets with their batch loader (``datasets``)."""

from cinema_tpu_torch.data.datasets import (
    BatchLoader,
    EDESClassificationDataset,
    EDESRegressionDataset,
    EDESSegmentationDataset,
    LandmarkDetectionDataset,
    LandmarkRegressionDataset,
    collate,
    fit_to_size,
    gaussian_heatmap,
    read_metadata,
    read_png_gray,
)
from cinema_tpu_torch.data.nifti import load_nifti, load_nifti_header, save_nifti

__all__ = [
    "BatchLoader",
    "EDESClassificationDataset",
    "EDESRegressionDataset",
    "EDESSegmentationDataset",
    "LandmarkDetectionDataset",
    "LandmarkRegressionDataset",
    "collate",
    "fit_to_size",
    "gaussian_heatmap",
    "load_nifti",
    "load_nifti_header",
    "read_metadata",
    "read_png_gray",
    "save_nifti",
]
