"""Normalization statistic banks (data copied from tpuwsi/preprocess/normalize.py)."""

from __future__ import annotations

import functools
import math

import torch

MEAN = {
    "TCGA": (58.2069073 / 255, 96.22645279 / 255, 70.26442606 / 255),
    "HEROHE": (224.46091564 / 255, 190.67338568 / 255, 218.47883547 / 255),
    "Ron": (0.8998, 0.8253, 0.9357),
    "Imagenet": (0.485, 0.456, 0.406),
    "Amir": (0.9357, 0.8253, 0.8998),
}

STD = {
    "TCGA": (
        40.40400300279664 / 255,
        58.90625962739444 / 255,
        45.09334057330417 / 255,
    ),
    "HEROHE": (
        math.sqrt(1110.25292532) / 255,
        math.sqrt(2950.9804851) / 255,
        math.sqrt(1027.10911208) / 255,
    ),
    "Ron": (0.1125, 0.1751, 0.0787),
    "Imagenet": (0.229, 0.224, 0.225),
    "Amir": (0.0787, 0.1751, 0.1125),
}

# the mean pixel that MyMeanPixelRegularization paints (augment.mean_pixel_regularization)
MEAN_PIXEL = (0.87316266, 0.79902739, 0.84941472)


@functools.lru_cache(maxsize=None)
def constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``values`` as a tensor on ``device``, made once: building a tensor from
    Python numbers on a CUDA device is a blocking copy, which waits for all
    the work queued before it."""
    return torch.tensor(values, dtype=dtype, device=device)


def normalize(x: torch.Tensor, norm_type: str = "Ron") -> torch.Tensor:
    """(..., H, W, 3) float in [0,1] → standardized."""
    mean = constant(MEAN[norm_type], x.dtype, x.device)
    std = constant(STD[norm_type], x.dtype, x.device)
    return (x - mean) / std
