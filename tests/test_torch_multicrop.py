"""tpuwsi_torch's multi-crop augmentation and stochastic depth held against
the JAX package on the CPU.

Each op gets the same fp32 images (numpy seed) and the same explicit random
parameters in both packages and must agree to 1e-5 (the same fp32 math; the
resampling and blur products sum in another order). Where the JAX op only
takes a key, the parameter is pinned through its range (a blur sigma range
of (s, s), a probability of 0 or 1). What the port draws itself is checked
as a distribution, over a few hundred seeded draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuwsi.models import vit as jvit
from tpuwsi.preprocess import augment as JA
from tpuwsi.preprocess import multicrop as jmc
from tpuwsi_torch.models import vit as tvit
from tpuwsi_torch.models.convert import params_from_flax
from tpuwsi_torch.preprocess import augment as TA
from tpuwsi_torch.preprocess import multicrop as tmc
from tpuwsi_torch.preprocess.normalize import MEAN, STD

TOL = dict(atol=1e-5, rtol=1e-5)
B, S = 5, 24


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    x = rng.random((B, S, S, 3), dtype=np.float32)
    x[1] = x[1].mean()          # a gray image: zero saturation, hue undefined
    x[2, ..., 1:] = x[2, ..., :1]  # r == g == b
    return x


def _per_image(fn, images, *params):
    """The JAX op on one image at a time, stacked."""
    return np.stack([np.asarray(fn(jnp.asarray(img), *(p[i] for p in params)))
                     for i, img in enumerate(images)])


@pytest.mark.parametrize("name,factors", [
    ("adjust_brightness", [0.6, 1.0, 1.4, 0.0, 1.39]),
    ("adjust_contrast", [0.6, 1.0, 1.4, 0.0, 1.39]),
    ("adjust_saturation", [0.8, 1.0, 1.2, 0.0, 1.19]),
    ("adjust_hue", [-0.1, 0.0, 0.1, 0.05, -0.03]),
])
def test_colour_ops_match_jax(images, name, factors):
    f = np.asarray(factors, np.float32)
    want = _per_image(getattr(JA, name), images, f)
    got = getattr(TA, name)(torch.from_numpy(images), torch.from_numpy(f))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    one = getattr(TA, name)(torch.from_numpy(images[0]), float(f[0]))  # unbatched, scalar
    np.testing.assert_allclose(one.numpy(), want[0], **TOL)


def test_hsv_round_trip_and_grayscale_match_jax(images):
    x = torch.from_numpy(images)
    np.testing.assert_allclose(TA._rgb_to_hsv(x).numpy(),
                               np.asarray(JA._rgb_to_hsv(jnp.asarray(images))), **TOL)
    hsv = np.asarray(JA._rgb_to_hsv(jnp.asarray(images)))
    np.testing.assert_allclose(TA._hsv_to_rgb(torch.from_numpy(hsv.copy())).numpy(),
                               np.asarray(JA._hsv_to_rgb(jnp.asarray(hsv))), **TOL)
    np.testing.assert_allclose(TA._grayscale(x).numpy(),
                               np.asarray(JA._grayscale(jnp.asarray(images))), **TOL)


def test_color_jitter_with_given_factors_matches_jax(images):
    ranges = TA.jitter_params(brightness=0.4, contrast=0.4, saturation=0.2, hue=0.1)
    assert ranges == JA.jitter_params(brightness=0.4, contrast=0.4, saturation=0.2, hue=0.1)
    rng = np.random.default_rng(1)
    factors = [rng.uniform(lo, hi, B).astype(np.float32) for lo, hi in ranges]

    def jitter(img, fb, fc, fs, fh):
        img = JA.adjust_brightness(img, fb)
        img = JA.adjust_contrast(img, fc)
        img = JA.adjust_saturation(img, fs)
        return JA.adjust_hue(img, fh)

    want = _per_image(jitter, images, *factors)
    got = TA.color_jitter(torch.from_numpy(images), *ranges,
                          factors=[torch.from_numpy(f) for f in factors])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("sigma", [0.1, 0.7, 2.0])
def test_gaussian_blur_matches_jax(images, sigma):
    want = _per_image(lambda img: JA.gaussian_blur(jax.random.PRNGKey(0), img, (sigma, sigma)),
                      images)
    got = TA.gaussian_blur(torch.from_numpy(images), sigma=torch.full((B,), sigma))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _reference_coords(area_u, log_ratio, u_top, u_left, h, w, out):
    """tpuwsi/preprocess/multicrop.py:57-85 on given draws, in fp32 numpy."""
    f = np.float32
    area = f(h * w) * f(area_u)
    ratio = np.exp(f(log_ratio))
    cw = np.clip(np.round(np.sqrt(area * ratio)), 1, w).astype(np.int32)
    ch = np.clip(np.round(np.sqrt(area / ratio)), 1, h).astype(np.int32)
    top = np.floor(f(u_top) * f(max(h - ch + 1, 1))).astype(np.int32)
    left = np.floor(f(u_left) * f(max(w - cw + 1, 1))).astype(np.int32)
    centres = np.arange(out, dtype=f) + f(0.5)
    return (top + centres * ch / out - f(0.5)).astype(f), (
        left + centres * cw / out - f(0.5)).astype(f)


@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
def test_crop_and_resample_match_jax(images, method, out=16):
    rng = np.random.default_rng(2)
    params = tmc.CropParams(
        area=torch.from_numpy(rng.uniform(0.05, 1.0, B).astype(np.float32)),
        log_ratio=torch.from_numpy(rng.uniform(np.log(3 / 4), np.log(4 / 3), B
                                               ).astype(np.float32)),
        top=torch.from_numpy(rng.random(B, dtype=np.float32)),
        left=torch.from_numpy(rng.random(B, dtype=np.float32)),
        flip=torch.tensor([True, False, True, False, True]))
    ys, xs = tmc.crop_coords(params, S, S, out)
    for i in range(B):
        want_ys, want_xs = _reference_coords(
            params.area[i].item(), params.log_ratio[i].item(), params.top[i].item(),
            params.left[i].item(), S, S, out)
        if params.flip[i]:
            want_xs = want_xs[::-1]
        np.testing.assert_allclose(ys[i].numpy(), want_ys, atol=1e-5)
        np.testing.assert_allclose(xs[i].numpy(), want_xs, atol=1e-5)
    ys, xs = ys.numpy(), xs.numpy()
    want = np.stack([np.asarray(JA.resample(jnp.asarray(images[i]), jnp.asarray(ys[i]),
                                            jnp.asarray(xs[i]), method=method))
                     for i in range(B)])
    got = tmc.random_resized_crop(torch.from_numpy(images), out, (0.05, 1.0), hflip=True,
                                  method=method, params=params)
    assert got.shape == (B, out, out, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        TA.interp_matrix_cubic(torch.from_numpy(ys[0]), S).numpy(),
        np.asarray(JA.interp_matrix_cubic(jnp.asarray(ys[0]), S)), **TOL)
    np.testing.assert_allclose(
        TA.interp_matrix(torch.from_numpy(ys[0]), S).numpy(),
        np.asarray(JA.interp_matrix(jnp.asarray(ys[0]), S)), **TOL)


def test_upscaling_crop_matches_jax(images):
    """A global view larger than the tile (448 px from 256-px tiles is 1.75x;
    here 42 from 24): the crop box is sampled more finely than the pixels,
    as in the JAX package, whatever the box's size."""
    test_crop_and_resample_match_jax(images, "bicubic", out=42)
    fn = tmc.make_multicrop(tmc.MultiCropConfig(global_size=112, local_size=24, n_local=2))
    tiles = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 64, 64, 3),
                                                               dtype=np.uint8))
    g, loc = fn(torch.Generator().manual_seed(1), tiles)
    assert g.shape == (2, 2, 112, 112, 3) and loc.shape == (2, 2, 24, 24, 3)
    assert torch.isfinite(g).all() and g.std() > 0.1


@pytest.mark.parametrize("p", [0.0, 1.0])
def test_grayscale_and_solarize_match_jax(images, p):
    key = jax.random.PRNGKey(0)
    apply = torch.full((B,), bool(p))
    x = torch.from_numpy(images)
    np.testing.assert_allclose(
        tmc.random_grayscale(x, apply=apply).numpy(),
        _per_image(lambda img: jmc.random_grayscale(key, img, p), images), **TOL)
    np.testing.assert_allclose(
        tmc.solarize(x, apply=apply).numpy(),
        _per_image(lambda img: jmc.solarize(key, img, p), images), **TOL)
    mixed = torch.tensor([True, False, True, False, False])
    out = tmc.solarize(x, apply=mixed)
    assert torch.equal(out[1], x[1]) and not torch.equal(out[0], x[0])


def test_multicrop_shapes_values_and_determinism():
    cfg = tmc.MultiCropConfig()
    assert (cfg.global_size, cfg.local_size, cfg.n_local) == (224, 96, 6)
    fn = tmc.make_multicrop(cfg)
    tiles = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 64, 64, 3),
                                                               dtype=np.uint8))
    g, loc = fn(torch.Generator().manual_seed(5), tiles)
    assert g.shape == (2, 2, 224, 224, 3) and loc.shape == (2, 6, 96, 96, 3)
    assert g.dtype == loc.dtype == torch.float32
    mean, std = torch.tensor(MEAN[cfg.norm_type]), torch.tensor(STD[cfg.norm_type])
    for views in (g, loc):  # un-normalised, every view is an image in [0, 1]
        raw = views * std + mean
        assert torch.isfinite(views).all() and raw.min() >= -1e-5 and raw.max() <= 1 + 1e-5
    g2, loc2 = fn(torch.Generator().manual_seed(5), tiles)
    assert torch.equal(g, g2) and torch.equal(loc, loc2)
    g3, _ = fn(torch.Generator().manual_seed(6), tiles)
    assert not torch.equal(g, g3)
    half = tmc.make_multicrop(tmc.MultiCropConfig(global_size=32, local_size=16,
                                                  compute_dtype="bfloat16"))
    gb, lb = half(torch.Generator().manual_seed(5), tiles)
    assert gb.dtype == lb.dtype == torch.bfloat16 and gb.shape == (2, 2, 32, 32, 3)


def test_multicrop_draws_follow_the_recipe(monkeypatch):
    """Through the real pipeline, 512 tiles per view: crop areas stay in each
    group's scale range, flips come at 0.5, jitter at 0.8 and grayscale at
    0.2 everywhere, and blur and solarise at the recipe's rates per view
    (global 0: 1.0 / 0; global 1: 0.1 / 0.2; local: 0.5 / 0)."""
    n, n_local = 512, 3
    coins, crops = [], []
    real_bernoulli, real_crop = tmc.bernoulli, tmc.draw_crop_params

    def spy_bernoulli(shape, p, generator, device):
        out = real_bernoulli(shape, p, generator, device)
        per_view = out.reshape(-1, n).float().mean(dim=1)
        ps = torch.as_tensor(p, dtype=torch.float32).expand(out.shape).reshape(-1, n)[:, 0]
        coins.append(list(zip(ps.tolist(), per_view.tolist())))
        return out

    def spy_crop(batch, scale_range, ratio_range, generator, device):
        out = real_crop(batch, scale_range, ratio_range, generator, device)
        crops.append((batch, scale_range, out))
        return out

    monkeypatch.setattr(tmc, "bernoulli", spy_bernoulli)
    monkeypatch.setattr(tmc, "draw_crop_params", spy_crop)
    fn = tmc.make_multicrop(tmc.MultiCropConfig(global_size=16, local_size=8, n_local=n_local))
    tiles = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (n, 16, 16, 3),
                                                               dtype=np.uint8))
    fn(torch.Generator().manual_seed(9), tiles)
    assert [(b, s) for b, s, _ in crops] == [(2 * n, (0.4, 1.0)), (n_local * n, (0.05, 0.4))]
    for _, (lo, hi), params in crops:
        assert lo <= params.area.min() and params.area.max() < hi
        assert params.area.max() - params.area.min() > 0.9 * (hi - lo)  # spans the range
        assert np.log(3 / 4) <= params.log_ratio.min() and params.log_ratio.max() < np.log(4 / 3)
        assert 0 <= params.top.min() and params.top.max() < 1
    # per group of views: flip, jitter, grayscale, blur, solarise
    want = [[0.5] * 2, [0.8] * 2, [0.2] * 2, [1.0, 0.1], [0.0, 0.2],
            [0.5] * 3, [0.8] * 3, [0.2] * 3, [0.5] * 3, [0.0] * 3]
    assert [[round(p, 6) for p, _ in call] for call in coins] == want
    for call in coins:
        for p, rate in call:
            assert abs(rate - p) <= 4 * (p * (1 - p) / n) ** 0.5  # four standard errors


_TINY = dict(img_size=32, patch_size=8, embed_dim=64, depth=4, num_heads=2)


def test_drop_path_masks_rates_and_scaling():
    model = tvit.VisionTransformer(tvit.ViTConfig(drop_path_rate=0.3, dtype=torch.float32,
                                                  **_TINY))
    rates = model.drop_path_rates
    np.testing.assert_allclose(rates, [0.0, 0.1, 0.2, 0.3])
    n = 4096
    masks = model.drop_path_masks(n, torch.device("cpu"), torch.Generator().manual_seed(0))
    assert masks.shape == (4, 2, n) and masks.dtype == torch.bool
    assert masks[0].all()  # layer 0 keeps everything
    for i, rate in enumerate(rates[1:], 1):
        for sub in range(2):
            keep = masks[i, sub].float().mean().item()
            assert abs(keep - (1 - rate)) <= 4 * (rate * (1 - rate) / n) ** 0.5
    y = torch.randn(6, 5, 8)
    mask = torch.tensor([True, False, True, True, False, True])
    out = tvit._drop_path(y, 0.2, mask)
    assert torch.equal(out[mask], y[mask] / 0.8) and (out[~mask] == 0).all()
    assert tvit._drop_path(y, 0.0, mask) is y and tvit._drop_path(y, 0.2, None) is y


def test_block_with_given_drop_path_masks_matches_jax():
    jcfg = jvit.ViTConfig(dtype=jnp.float32, use_pallas_attention=False, gelu_approx=True,
                          **{**_TINY, "depth": 1})
    variables = jvit.VisionTransformer(jcfg).init(jax.random.PRNGKey(0),
                                                  jnp.zeros((1, 32, 32, 3)))
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    model = tvit.VisionTransformer(tvit.ViTConfig(dtype=torch.float32, gelu_approx=True,
                                                  **{**_TINY, "depth": 1}))
    model.load_state_dict(params_from_flax(tree))
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 17, 64), dtype=np.float32)
    masks = np.array([[True, False, True, True], [False, True, True, False]])
    jblock = jvit.Block(num_heads=2, mlp_ratio=4.0, qkv_bias=True, drop=0.0, attn_drop=0.0,
                        drop_path=0.25, dtype=jnp.float32, use_pallas=False, gelu_approx=True)
    want, _ = jblock.apply({"params": tree["params"]["blocks_0"]}, jnp.asarray(x), False,
                           False, jnp.asarray(masks)[:, :, None, None])
    block = model.blocks[0]
    block.drop_path = 0.25
    got = block(torch.from_numpy(x), deterministic=False, drop_path_mask=torch.from_numpy(masks))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_vit_deterministic_is_exact_and_training_draws_from_the_generator():
    torch.manual_seed(0)
    cfg = tvit.ViTConfig(drop_path_rate=0.5, dtype=torch.float32, **_TINY)
    model = tvit.VisionTransformer(cfg)
    still = tvit.VisionTransformer(tvit.ViTConfig(dtype=torch.float32, **_TINY))
    still.load_state_dict(model.state_dict())
    x = torch.randn(8, 32, 32, 3)
    assert torch.equal(model(x), still(x))  # deterministic: stochastic depth is off
    assert torch.equal(model(x, deterministic=True), still(x, deterministic=False))
    a = model(x, deterministic=False, generator=torch.Generator().manual_seed(1))
    b = model(x, deterministic=False, generator=torch.Generator().manual_seed(1))
    c = model(x, deterministic=False, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, model(x))
    # gradients reach the fp32 parameters through the per-call casts
    half = tvit.VisionTransformer(tvit.ViTConfig(drop_path_rate=0.1, **_TINY))
    half(x, deterministic=False, generator=torch.Generator().manual_seed(1)).sum().backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in half.parameters())
