"""Named augmentation recipes (``tpuwsi/preprocess/recipes.py``).

Every recipe name, parameter value and op order of the reference
(transformations.py:103-208), and the cutout appended after normalisation
for ``cbnfrsc``, ``bnfrsc`` and ``pcbnfrsc`` (:206-207). A recipe is one
function over the whole batch: each op draws one value per image from the
generator it is given, in the recipe's op order (the post-normalisation
cutout last), or takes the values from ``draws``, a dict with one entry per
op name of ``recipe_ops`` plus ``"cutout"`` where the recipe appends one.
At eval time every recipe is the same: uint8 → float32 / 255 → normalise
with the named bank. The timm stack (``--transform_type timm``) is not
ported (ROADMAP.md, Queue 1, M3b).
"""

from __future__ import annotations

import functools
from typing import Callable, List, Tuple

import torch

from tpuwsi_torch.preprocess import augment as A
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

SCALE_FACTOR = 0.2  # transformations.py:129
BLUR_SIGMA = (1e-7, 1e-1)  # transformations.py:144
NOISE_SIGMA = (0.0, 0.05)  # transformations.py:145
CUTOUT_LEN = 100  # transformations.py:169,207
POST_NORM_CUTOUT = ("cbnfrsc", "bnfrsc", "pcbnfrsc")

# one op of a recipe: fn(images, generator, draws or None) → images
Op = Tuple[str, Callable]


def _jitter(ranges):
    return ("jitter", lambda img, g, d: A.color_jitter(img, *ranges, generator=g, factors=d))


def _noise(img, g, d):
    stdev, noise = d if d is not None else (None, None)
    return A.gaussian_noise(img, NOISE_SIGMA, g, stdev=stdev, noise=noise)


_BLUR = ("blur", lambda img, g, d: A.gaussian_blur3(img, BLUR_SIGMA, g, sigma=d))
_NOISE = ("noise", _noise)
_VFLIP = ("vflip", lambda img, g, d: A.random_vflip(img, generator=g, flip=d))
_HFLIP = ("hflip", lambda img, g, d: A.random_hflip(img, generator=g, flip=d))
_ROT90 = ("rot90", lambda img, g, d: A.random_rot90(img, generator=g, k=d))
_ZOOM = ("zoom", lambda img, g, d: A.random_zoom(img, (1.0, 1.0 + SCALE_FACTOR), g, scale=d))
_CUTOUT = ("cutout", lambda img, g, d: A.cutout(img, CUTOUT_LEN, 0.0, g, centre=d))
_MEAN_PIXEL = ("mean_pixel",
               lambda img, g, d: A.mean_pixel_regularization(img, generator=g, replace=d))

_FIXED_JITTER = dict(brightness=(0.85, 1.15), contrast=(0.75, 1.25), saturation=0.1,
                     hue=(-0.1, 0.1))


def recipe_ops(transform_type: str, color_param: float = 0.1) -> List[Op]:
    """The train recipe's ops before normalisation, in order, as
    ``(draw name, op)``."""
    if transform_type == "none":
        return []
    if transform_type == "flip":
        return [_VFLIP, _HFLIP]
    if transform_type == "rvf":
        return [_ROT90, _VFLIP]
    if transform_type in ("cbnfrsc", "cbnfrs", "cbnfr"):
        ops = [_jitter(A.jitter_params(**_FIXED_JITTER)), _BLUR, _NOISE, _VFLIP, _ROT90]
        return ops if transform_type == "cbnfr" else ops + [_ZOOM]
    if transform_type in ("pcbnfrsc", "pcbnfrs"):
        jitter = A.jitter_params(brightness=color_param, contrast=color_param * 2,
                                 saturation=color_param, hue=color_param)
        return [_jitter(jitter), _BLUR, _NOISE, _VFLIP, _ROT90, _ZOOM]
    if transform_type in ("bnfrsc", "bnfrs"):
        return [_BLUR, _NOISE, _VFLIP, _ROT90, _ZOOM]
    if transform_type == "frs":
        return [_VFLIP, _ROT90, _ZOOM]
    if transform_type == "aug_receptornet":
        jitter = A.jitter_params(brightness=64.0 / 255, contrast=0.75, saturation=0.25,
                                 hue=0.04)
        # cutout and the mean pixel before normalisation for this recipe
        # (transformations.py:162-171)
        return [_jitter(jitter), _HFLIP, _ROT90, _CUTOUT, _MEAN_PIXEL]
    raise ValueError(f"unknown transform type {transform_type!r}")


def _apply(ops: List[Op], post_norm_cutout: bool, norm_type: str, images: torch.Tensor,
           generator=None, draws=None) -> torch.Tensor:
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    for name, op in ops:
        images = op(images, generator, None if draws is None else draws[name])
    images = normalize(images, norm_type)
    if post_norm_cutout:
        images = _CUTOUT[1](images, generator, None if draws is None else draws["cutout"])
    return images


def make_recipe(
    transform_type: str,
    train: bool,
    tile_size: int = 256,
    color_param: float = 0.1,
    norm_type: str = "Ron",
) -> Callable[..., torch.Tensor]:
    """Return ``fn(images, generator=None, draws=None)``: (B, H, W, 3) uint8,
    or float in [0, 1] → normalised float32. ``tile_size`` is the
    reference's argument and changes nothing here."""
    if transform_type == "timm":
        raise NotImplementedError(
            "--transform_type timm (the timm transform stack, timm_aug.py) is not ported yet "
            "(ROADMAP.md, Queue 1, M3b)")
    if transform_type not in RECIPE_NAMES:
        raise ValueError(f"unknown transform type {transform_type!r}")
    ops = recipe_ops(transform_type, color_param) if train else []
    return functools.partial(_apply, ops, train and transform_type in POST_NORM_CUTOUT,
                             norm_type)
