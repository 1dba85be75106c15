"""The port's data engine (port of cinema_tpu/data): the NIfTI reader and writer with frame seeks
(``nifti``), the PNG reader that reads what PIL reads (``png``), the augmentation transforms (``transforms``), and the datasets with their batch loader and
device prefetch (``datasets``): the ED/ES datasets, the per-frame cine, EMIDEC, MyoPS2020 and Kaggle video
datasets, the landmark datasets and the UKB pretraining dataset; and, for the offline preprocessing CLIs
(``preprocess``), the DICOM reader (``dicom``), the geometry and intensity helpers (``geometry``) and oriented
volumes (``volume``)."""

from cinema_tpu_torch.data.datasets import (
    BatchLoader,
    CineSegmentationDataset,
    EDESClassificationDataset,
    EDESRegressionDataset,
    EDESSegmentationDataset,
    EMIDECDataset,
    KaggleVideoDataset,
    LandmarkDetectionDataset,
    LandmarkRegressionDataset,
    MYOPS2020Dataset,
    UKBCineDataset,
    collate,
    device_prefetch,
    find_view_file,
    gaussian_heatmap,
    read_metadata,
    read_png_gray,
    to_device,
)
from cinema_tpu_torch.data.nifti import (
    load_nifti,
    load_nifti_frame,
    load_nifti_header,
    read_frame_index,
    save_nifti,
    save_nifti_like,
)

__all__ = [
    "BatchLoader",
    "CineSegmentationDataset",
    "EDESClassificationDataset",
    "EDESRegressionDataset",
    "EDESSegmentationDataset",
    "EMIDECDataset",
    "KaggleVideoDataset",
    "LandmarkDetectionDataset",
    "LandmarkRegressionDataset",
    "MYOPS2020Dataset",
    "UKBCineDataset",
    "collate",
    "device_prefetch",
    "find_view_file",
    "gaussian_heatmap",
    "load_nifti",
    "load_nifti_frame",
    "load_nifti_header",
    "read_frame_index",
    "read_metadata",
    "read_png_gray",
    "save_nifti",
    "save_nifti_like",
    "to_device",
]
