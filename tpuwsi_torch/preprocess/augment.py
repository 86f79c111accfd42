"""On-device augmentation primitives (``tpuwsi/preprocess/augment.py``): the
ops that DINO multi-crop and the train recipes call.

Every op works on a batch ``(B, H, W, 3)`` of float images in [0, 1] at once
(or on one ``(H, W, 3)`` image). The colour adjustments take their random
parameter as an argument: a tensor with one value per image, or a scalar.
The random ops draw theirs from an explicit ``torch.Generator``, one value
per image, unless the caller passes them in (so that tests can feed two
packages the same draws). Resampling and blur are matrix products with
small per-image operators, as in the reference; in bf16 they take bf16
operands and round the fp32 sums back.
"""

from __future__ import annotations

import torch

from tpuwsi_torch.preprocess.normalize import MEAN_PIXEL, constant


def _per_image(value, img: torch.Tensor) -> torch.Tensor:
    """``value`` (scalar or (B,)) shaped to broadcast over ``img``'s pixels."""
    value = torch.as_tensor(value, dtype=img.dtype, device=img.device)
    return value.reshape(value.shape + (1,) * (img.dim() - value.dim()))


def _grayscale(img):
    return img[..., 0] * 0.2989 + img[..., 1] * 0.587 + img[..., 2] * 0.114


def _blend(a, b, factor):
    return a * factor + b * (1.0 - factor)


def adjust_brightness(img, factor):
    return torch.clamp(img * _per_image(factor, img), 0.0, 1.0)


def adjust_contrast(img, factor):
    gray_mean = _grayscale(img).mean(dim=(-2, -1), keepdim=True)[..., None]
    return torch.clamp(_blend(img, gray_mean, _per_image(factor, img)), 0.0, 1.0)


def adjust_saturation(img, factor):
    gray = _grayscale(img)[..., None]
    return torch.clamp(_blend(img, gray, _per_image(factor, img)), 0.0, 1.0)


def _rgb_to_hsv(img):
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    zero, one = torch.zeros_like(maxc), torch.ones_like(maxc)
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), zero)
    safe_delta = torch.where(delta == 0, one, delta)
    rc = (maxc - r) / safe_delta
    gc = (maxc - g) / safe_delta
    bc = (maxc - b) / safe_delta
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta == 0, zero, h)
    h = torch.remainder(h / 6.0, 1.0)
    return torch.stack([h, s, maxc], dim=-1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6).long()

    def pick(*by_sector):
        return torch.gather(torch.stack(by_sector, dim=-1), -1, i[..., None])[..., 0]

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)


def adjust_hue(img, shift):
    hsv = _rgb_to_hsv(img)
    h = torch.remainder(hsv[..., 0] + _per_image(shift, hsv[..., 0]), 1.0)
    return _hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))


def jitter_params(brightness=None, contrast=None, saturation=None, hue=None):
    """torchvision ColorJitter argument normalisation: scalar b → (1-b, 1+b)
    clipped at 0; scalar hue h → (-h, h)."""

    def sym(v):
        if v is None:
            return None
        if isinstance(v, (tuple, list)):
            return tuple(v)
        return (max(0.0, 1.0 - v), 1.0 + v)

    def hue_rng(v):
        if v is None:
            return None
        if isinstance(v, (tuple, list)):
            return tuple(v)
        return (-v, v)

    return sym(brightness), sym(contrast), sym(saturation), hue_rng(hue)


def uniform(shape, lo: float, hi: float, generator, device) -> torch.Tensor:
    """fp32 U[lo, hi) of ``shape`` from ``generator`` on ``device``."""
    return lo + (hi - lo) * torch.rand(shape, generator=generator, device=device)


def color_jitter(img, brightness, contrast, saturation, hue, generator=None, factors=None):
    """brightness/contrast/saturation/hue: (lo, hi) ranges or None, applied
    in that fixed order. ``factors``: the four per-image factors (None where
    the range is None); drawn from ``generator`` in the same order when not
    given."""
    ops = (adjust_brightness, adjust_contrast, adjust_saturation, adjust_hue)
    ranges = (brightness, contrast, saturation, hue)
    if factors is None:
        factors = [None if r is None else uniform(img.shape[:-3], r[0], r[1], generator,
                                                  img.device) for r in ranges]
    for op, rng, f in zip(ops, ranges, factors):
        if rng is not None:
            img = op(img, f)
    return img


def _matmul_dtype(img):
    return torch.bfloat16 if img.dtype == torch.bfloat16 else torch.float32


def _apply_separable(img, my, mx):
    """``my`` (..., Ho, H) over rows, then ``mx`` (..., Wo, W) over columns."""
    dt = _matmul_dtype(img)
    tmp = torch.einsum("...oh,...hwc->...owc", my.to(dt), img.to(dt))
    return torch.einsum("...pw,...owc->...opc", mx.to(dt), tmp).to(img.dtype)


def gaussian_blur(img, sigma_range=(0.1, 2.0), generator=None, sigma=None):
    """Full (untruncated) separable Gaussian blur with a per-image σ ~
    U[range] (or the ``sigma`` given), as two products with the dense
    row-normalised Gaussian operators."""
    if sigma is None:
        sigma = uniform(img.shape[:-3], sigma_range[0], sigma_range[1], generator, img.device)
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=img.device)[..., None, None]
    h, w = img.shape[-3], img.shape[-2]

    def op(n):
        i = torch.arange(n, dtype=torch.float32, device=img.device)
        b = torch.exp(-0.5 * ((i[:, None] - i[None, :]) / sigma) ** 2)
        return (b / b.sum(dim=-1, keepdim=True)).to(img.dtype)

    by = op(h)
    bx = by if w == h else op(w)
    return _apply_separable(img, by, bx)


def interp_matrix(coords, in_size: int):
    """Bilinear-interpolation matrix (..., out, in): ``M @ img`` samples img
    rows at the fractional positions ``coords`` (..., out), edges clamped."""
    y0 = torch.clamp(torch.floor(coords), 0, in_size - 1)
    y1 = torch.clamp(y0 + 1, 0, in_size - 1)
    w = torch.clamp(coords - y0, 0.0, 1.0)
    cols = torch.arange(in_size, device=coords.device)
    return ((cols == y0.long()[..., None]) * (1.0 - w)[..., None]
            + (cols == y1.long()[..., None]) * w[..., None])


def _cubic_w(t, a: float = -0.5):
    """Cubic-convolution kernel (Keys, a = -0.5: PIL/torch BICUBIC)."""
    at = t.abs()
    w1 = ((a + 2) * at - (a + 3)) * at * at + 1.0
    w2 = a * (((at - 5) * at + 8) * at - 4)
    return torch.where(at <= 1, w1, torch.where(at < 2, w2, torch.zeros_like(at)))


def interp_matrix_cubic(coords, in_size: int):
    """Bicubic-interpolation matrix (..., out, in), same contract as
    ``interp_matrix``: four cubic taps per output position, edge taps
    clamp-accumulated (replicate padding), no antialias prefilter."""
    base = torch.floor(coords)
    cols = torch.arange(in_size, device=coords.device)
    m = torch.zeros(coords.shape + (in_size,), dtype=torch.float32, device=coords.device)
    for k in (-1, 0, 1, 2):
        idx = torch.clamp(base + k, 0, in_size - 1).long()[..., None]
        m = m + (cols == idx) * _cubic_w(coords - (base + k))[..., None]
    return m


def resample(img, ys, xs, method: str = "bilinear"):
    """Sample img (..., H, W, C) at row positions ys (..., Ho) and column
    positions xs (..., Wo) → (..., Ho, Wo, C); leading axes broadcast, so
    several sets of positions can share one image. ``method``: 'bilinear' |
    'bicubic'."""
    h, w = img.shape[-3], img.shape[-2]
    ys, xs = ys.float(), xs.float()
    if method == "bicubic":
        my, mx = interp_matrix_cubic(ys, h), interp_matrix_cubic(xs, w)
    elif method == "bilinear":
        my, mx = interp_matrix(ys, h), interp_matrix(xs, w)
    else:
        raise ValueError(f"unknown interpolation {method!r}")
    return _apply_separable(img, my, mx)


def _mask(value, img: torch.Tensor) -> torch.Tensor:
    """A per-image bool (scalar or (B,)) shaped to broadcast over ``img``'s pixels."""
    value = torch.as_tensor(value, dtype=torch.bool, device=img.device)
    return value.reshape(value.shape + (1,) * (img.dim() - value.dim()))


def _bernoulli(img, p: float, generator) -> torch.Tensor:
    return torch.rand(img.shape[:-3], generator=generator, device=img.device) < p


def _randint(img, high: int, generator) -> torch.Tensor:
    return torch.randint(0, high, img.shape[:-3], generator=generator, device=img.device)


def gaussian_blur3(img, sigma_range=(1e-7, 1e-1), generator=None, sigma=None):
    """3×3 separable Gaussian blur with a per-image σ ~ U[range] (or the
    ``sigma`` given), edges padded by replication, rows then columns."""
    if sigma is None:
        sigma = uniform(img.shape[:-3], sigma_range[0], sigma_range[1], generator, img.device)
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=img.device)[..., None]
    x = torch.arange(-1, 2, dtype=torch.float32, device=img.device)
    w = torch.exp(-0.5 * (x / sigma) ** 2)
    w = (w / w.sum(dim=-1, keepdim=True)).to(img.dtype)
    w0, w1, w2 = (_per_image(w[..., i], img) for i in range(3))
    pad = torch.cat([img[..., :1, :, :], img, img[..., -1:, :, :]], dim=-3)
    img = pad[..., :-2, :, :] * w0 + pad[..., 1:-1, :, :] * w1 + pad[..., 2:, :, :] * w2
    pad = torch.cat([img[..., :1, :], img, img[..., -1:, :]], dim=-2)
    return pad[..., :-2, :] * w0 + pad[..., 1:-1, :] * w1 + pad[..., 2:, :] * w2


def gaussian_noise(img, sigma_range=(0.0, 0.05), generator=None, stdev=None, noise=None):
    """img + σ · N(0, 1) with a per-image σ ~ U[range] (drawn first, then the
    noise field; or both given), clipped to [0, 1] and put back on the uint8
    grid (floor(x · 255) / 255), as skimage's random_noise and a uint8 round
    trip do."""
    if stdev is None:
        stdev = uniform(img.shape[:-3], sigma_range[0], sigma_range[1], generator, img.device)
    if noise is None:
        noise = torch.randn(img.shape, generator=generator, device=img.device, dtype=img.dtype)
    noisy = torch.clamp(img + _per_image(stdev, img) * noise, 0.0, 1.0)
    return torch.floor(noisy * 255.0) / 255.0


def random_vflip(img, p: float = 0.5, generator=None, flip=None):
    """Each image upside down with probability ``p`` (or where ``flip`` holds)."""
    if flip is None:
        flip = _bernoulli(img, p, generator)
    return torch.where(_mask(flip, img), img.flip(-3), img)


def random_hflip(img, p: float = 0.5, generator=None, flip=None):
    """Each image mirrored left to right with probability ``p`` (or where ``flip`` holds)."""
    if flip is None:
        flip = _bernoulli(img, p, generator)
    return torch.where(_mask(flip, img), img.flip(-2), img)


def random_rot90(img, generator=None, k=None):
    """Each square image turned by k · 90° anticlockwise (``np.rot90``), k
    uniform in {0, 1, 2, 3} or given: k = 1 mirrors the columns then
    transposes, k = 2 mirrors both axes, k = 3 mirrors the rows then
    transposes."""
    if img.shape[-3] != img.shape[-2]:
        raise ValueError(f"random_rot90 turns square images, got {tuple(img.shape[-3:-1])}")
    if k is None:
        k = _randint(img, 4, generator)
    k = torch.as_tensor(k, device=img.device)
    rows, cols, turn = (k == 2) | (k == 3), (k == 1) | (k == 2), (k == 1) | (k == 3)
    img = torch.where(_mask(rows, img), img.flip(-3), img)
    img = torch.where(_mask(cols, img), img.flip(-2), img)
    return torch.where(_mask(turn, img), img.transpose(-3, -2), img)


def random_zoom(img, scale_range=(1.0, 1.2), generator=None, scale=None):
    """RandomAffine(degrees=0, scale=s): a zoom by a per-image s ~ U[range]
    (or ``scale``) about the centre, bilinear."""
    if scale is None:
        scale = uniform(img.shape[:-3], scale_range[0], scale_range[1], generator, img.device)
    s = torch.as_tensor(scale, dtype=torch.float32, device=img.device)[..., None]
    h, w = img.shape[-3], img.shape[-2]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys = (torch.arange(h, dtype=torch.float32, device=img.device) - cy) / s + cy
    xs = (torch.arange(w, dtype=torch.float32, device=img.device) - cx) / s + cx
    return resample(img, ys, xs, "bilinear")


def cutout(img, length: int = 100, fill: float = 0.0, generator=None, centre=None):
    """Set one ``length``² square of each image to ``fill``, clipped to the image,
    around a centre (y, x) uniform over the pixels (y drawn first) or given
    as two per-image integer tensors."""
    h, w = img.shape[-3], img.shape[-2]
    if centre is None:
        centre = (_randint(img, h, generator), _randint(img, w, generator))
    y, x = (torch.as_tensor(c, device=img.device)[..., None] for c in centre)
    rows = torch.arange(h, device=img.device)
    cols = torch.arange(w, device=img.device)
    row_in = (rows >= y - length // 2) & (rows < y + length // 2)
    col_in = (cols >= x - length // 2) & (cols < x + length // 2)
    hole = (row_in[..., :, None] & col_in[..., None, :])[..., None]
    return torch.where(hole, torch.full_like(img, fill), img)


def mean_pixel_regularization(img, p: float = 0.75, generator=None, replace=None):
    """Each image replaced whole by the mean pixel with probability ``p`` (or
    where ``replace`` holds)."""
    if replace is None:
        replace = _bernoulli(img, p, generator)
    pix = constant(MEAN_PIXEL, img.dtype, img.device)
    return torch.where(_mask(replace, img), pix.expand_as(img), img)
