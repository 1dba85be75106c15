"""The port's public constants (port of cinema_tpu/constants.py; reference cinema/__init__.py:3-34): the UK
Biobank geometry, the view names, the unified segmentation labels and the EF thresholds."""

from __future__ import annotations

# UK Biobank acquisition geometry (reference cinema/__init__.py:12-16)
UKB_N_SUBJECTS = 69779
UKB_SPACING = (1.0, 1.0, 10.0)
UKB_LAX_SLICE_SIZE = (256, 256)
UKB_SAX_SLICE_SIZE = (192, 192)
UKB_N_FRAMES = 50

# unified segmentation labels (reference cinema/__init__.py:18-21)
BACKGROUND_LABEL = 0
RV_LABEL = 1
MYO_LABEL = 2
LV_LABEL = 3
LABEL_TO_NAME = {RV_LABEL: "RV", MYO_LABEL: "MYO", LV_LABEL: "LV"}

# canonical view names
VIEW_SAX = "sax"
VIEW_LAX_2C = "lax_2c"
VIEW_LAX_3C = "lax_3c"
VIEW_LAX_4C = "lax_4c"
ALL_VIEWS = (VIEW_SAX, VIEW_LAX_2C, VIEW_LAX_3C, VIEW_LAX_4C)

# EF clinical thresholds in percent (reference cinema/metric.py:14-16)
REDUCED_EF = 40
NORMAL_EF = 55
