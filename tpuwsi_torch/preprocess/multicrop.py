"""DINO multi-crop augmentation on the device (``tpuwsi/preprocess/multicrop.py``).

2 global + N local crops per tile: random resized crop (bicubic, horizontal
flip folded into the sample coordinates), colour jitter (p = 0.8), grayscale
(p = 0.2), Gaussian blur, solarisation (second global view only), normalise.
All views of one size are computed for the whole batch at once (a few
thousand small kernel launches per view pipeline make the host, not the
card, the limit otherwise); every random decision is a tensor with one
value per (view, image), drawn from one explicit ``torch.Generator``, or
handed in.

Draw order of one group of views (``_dino_views``), each draw of shape
``(n_views * B,)``, view-major: crop area, log aspect ratio, top, left,
flip; brightness, contrast, saturation and hue factors; jitter on/off;
grayscale on/off; blur sigma; blur on/off; solarise on/off.
``make_multicrop`` makes the global views, then the local views.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch

from tpuwsi_torch.preprocess import augment as A
from tpuwsi_torch.preprocess.normalize import normalize


@dataclasses.dataclass(frozen=True)
class MultiCropConfig:
    global_size: int = 224
    local_size: int = 96
    n_local: int = 6
    global_scale: Tuple[float, float] = (0.4, 1.0)
    local_scale: Tuple[float, float] = (0.05, 0.4)
    norm_type: str = "Ron"
    # augmentation compute type; "bfloat16" halves the traffic of the
    # elementwise view pipeline
    compute_dtype: str = "float32"


class CropParams(NamedTuple):
    """Per-image random parameters of ``random_resized_crop``, each (B,)."""

    area: torch.Tensor       # fraction of the image area, U[scale_range]
    log_ratio: torch.Tensor  # log aspect ratio, U[log ratio_range]
    top: torch.Tensor        # U[0, 1): position of the box among its valid tops
    left: torch.Tensor       # U[0, 1): likewise for the left edge
    flip: torch.Tensor       # bool: horizontal flip


def draw_crop_params(batch: int, scale_range, ratio_range, generator, device) -> CropParams:
    return CropParams(
        A.uniform((batch,), scale_range[0], scale_range[1], generator, device),
        A.uniform((batch,), math.log(ratio_range[0]), math.log(ratio_range[1]), generator,
                  device),
        A.uniform((batch,), 0.0, 1.0, generator, device),
        A.uniform((batch,), 0.0, 1.0, generator, device),
        bernoulli((batch,), 0.5, generator, device))


def bernoulli(shape, p, generator, device) -> torch.Tensor:
    """True with probability ``p``, a float or a tensor that broadcasts to
    ``shape``."""
    return torch.rand(shape, generator=generator, device=device) < p


def crop_coords(params: CropParams, h: int, w: int, out_size: int, hflip: bool = True):
    """Sample positions ``(ys, xs)``, each (B, out_size), of the crop boxes:
    torchvision RandomResizedCrop's box (width and height rounded and clipped
    to the image, the corner uniform over its valid positions) sampled at
    pixel centres, with ``xs`` reversed where ``params.flip`` holds."""
    area = h * w * params.area.float()
    ratio = torch.exp(params.log_ratio.float())
    cw = torch.clamp(torch.round(torch.sqrt(area * ratio)), 1, w)
    ch = torch.clamp(torch.round(torch.sqrt(area / ratio)), 1, h)
    top = torch.floor(params.top.float() * torch.clamp(h - ch + 1, min=1))
    left = torch.floor(params.left.float() * torch.clamp(w - cw + 1, min=1))
    centres = torch.arange(out_size, dtype=torch.float32, device=area.device) + 0.5
    ys = top[:, None] + centres * ch[:, None] / out_size - 0.5
    xs = left[:, None] + centres * cw[:, None] / out_size - 0.5
    if hflip:
        xs = torch.where(params.flip[:, None], xs.flip(-1), xs)
    return ys, xs


def random_resized_crop(images, out_size: int, scale_range, ratio_range=(3 / 4, 4 / 3),
                        generator=None, hflip: bool = False, method: str = "bilinear",
                        params: CropParams | None = None, n_views: int = 1):
    """torchvision RandomResizedCrop semantics on (B, H, W, C): ``n_views``
    boxes per image → (n_views * B, out_size, out_size, C), view-major; the
    images are not copied per view. ``hflip`` folds a p = 0.5 flip into the
    sample coordinates. ``params`` holds one entry per (view, image)."""
    b, h, w, _ = images.shape
    if params is None:
        params = draw_crop_params(n_views * b, scale_range, ratio_range, generator,
                                  images.device)
    ys, xs = crop_coords(params, h, w, out_size, hflip)
    out = A.resample(images, ys.reshape(n_views, b, -1), xs.reshape(n_views, b, -1),
                     method=method)
    return out.reshape((n_views * b,) + out.shape[2:])


def _select(apply, a, b):
    return torch.where(apply.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)


def random_grayscale(img, p: float = 0.2, generator=None, apply=None):
    if apply is None:
        apply = bernoulli(img.shape[:1], p, generator, img.device)
    gray = A._grayscale(img)[..., None].expand_as(img)
    return _select(apply, gray, img)


def solarize(img, p: float = 0.2, threshold: float = 0.5, generator=None, apply=None):
    if apply is None:
        apply = bernoulli(img.shape[:1], p, generator, img.device)
    return _select(apply, torch.where(img >= threshold, 1.0 - img, img), img)


_DINO_JITTER = A.jitter_params(brightness=0.4, contrast=0.4, saturation=0.2, hue=0.1)


def _dino_views(images, n_views: int, out_size: int, scale_range, blur_p, solarize_p,
                generator):
    """``n_views`` DINO views of every image of (B, H, W, 3), view-major:
    (n_views * B, out_size, out_size, 3). ``blur_p`` and ``solarize_p`` hold
    one probability per view."""
    b, dev = images.shape[0], images.device
    n = n_views * b

    def per_view(ps):
        return torch.tensor(ps, dtype=torch.float32, device=dev).repeat_interleave(b)

    # bicubic as in DINO's DataAugmentationDINO; clip the cubic overshoot
    # like PIL's uint8 clamp
    v = torch.clamp(
        random_resized_crop(images, out_size, scale_range, generator=generator, hflip=True,
                            method="bicubic", n_views=n_views), 0.0, 1.0)
    jittered = A.color_jitter(v, *_DINO_JITTER, generator=generator)
    v = _select(bernoulli((n,), 0.8, generator, dev), jittered, v)
    v = random_grayscale(v, 0.2, generator)
    blurred = A.gaussian_blur(v, (0.1, 2.0), generator)
    v = _select(bernoulli((n,), per_view(blur_p), generator, dev), blurred, v)
    return solarize(v, per_view(solarize_p), generator=generator)


def make_multicrop(cfg: MultiCropConfig):
    """Returns ``fn(generator, images (B, H, W, 3) uint8 or float) →
    (globals (B, 2, Sg, Sg, 3), locals (B, n_local, Sl, Sl, 3))``, normalised,
    in ``cfg.compute_dtype``. The second global view alone is solarised
    (p = 0.2) and rarely blurred (p = 0.1; the first always, a local view
    half the time)."""
    dt = getattr(torch, cfg.compute_dtype)

    def batch_fn(generator, images):
        images = images.to(dt) / 255.0 if images.dtype == torch.uint8 else images.to(dt)
        b, nl = images.shape[0], cfg.n_local
        g = _dino_views(images, 2, cfg.global_size, cfg.global_scale, (1.0, 0.1), (0.0, 0.2),
                        generator)
        loc = _dino_views(images, nl, cfg.local_size, cfg.local_scale, (0.5,) * nl,
                          (0.0,) * nl, generator)
        g = g.reshape((2, b) + g.shape[1:]).transpose(0, 1)
        loc = loc.reshape((nl, b) + loc.shape[1:]).transpose(0, 1)
        return normalize(g, cfg.norm_type), normalize(loc, cfg.norm_type)

    return batch_fn
