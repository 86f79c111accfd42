"""Named preprocessing recipes; only the eval recipe is ported so far.

Counterpart of ``tpuwsi/preprocess/recipes.py``. At eval time every recipe
is the same: uint8 → float32 / 255 → normalise with the named bank.
"""

from __future__ import annotations

from typing import Callable

import torch

from tpuwsi_torch.preprocess.normalize import normalize

RECIPE_NAMES = (
    "flip",
    "rvf",
    "cbnfrsc",
    "cbnfrs",
    "pcbnfrsc",
    "pcbnfrs",
    "aug_receptornet",
    "cbnfr",
    "bnfrsc",
    "bnfrs",
    "frs",
    "none",
)


def make_recipe(
    transform_type: str,
    train: bool,
    tile_size: int = 256,
    norm_type: str = "Ron",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Return fn(images): (B, H, W, 3) uint8, or float in [0,1] → normalised float32.

    ``tile_size`` only matters to the train recipes.
    """
    if transform_type not in RECIPE_NAMES:
        raise ValueError(f"unknown transform type {transform_type!r}")
    if train:
        raise NotImplementedError(
            f"train-time recipe {transform_type!r}: the augmentation ops are "
            "ported with the supervised and DINO slices (ROADMAP.md, Queue 1)")

    def batch_fn(images: torch.Tensor) -> torch.Tensor:
        if images.dtype == torch.uint8:
            images = images.float() / 255.0
        return normalize(images, norm_type)

    return batch_fn
