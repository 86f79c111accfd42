"""Normalization statistic banks (data copied from tpuwsi/preprocess/normalize.py)."""

from __future__ import annotations

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


def normalize(x: torch.Tensor, norm_type: str = "Ron") -> torch.Tensor:
    """(..., H, W, 3) float in [0,1] → standardized."""
    mean = torch.tensor(MEAN[norm_type], dtype=x.dtype, device=x.device)
    std = torch.tensor(STD[norm_type], dtype=x.dtype, device=x.device)
    return (x - mean) / std
