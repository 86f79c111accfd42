"""The port's train recipes and their augmentation ops held against the JAX
package's on the CPU.

The JAX ops draw from PRNG keys inside the recipe. The test replays each
key split of ``tpuwsi/preprocess/recipes.py`` and each op's draw
(``jax.random.uniform``, ``normal``, ``bernoulli``, ``randint``) outside the
recipe, and hands the port those values as ``draws``, so both packages
apply the same parameters to the same fp32 images (numpy seed); they must
agree to 1e-5. What the port draws from its own generator is checked for
its ranges and its reproducibility.

One thing differs by construction: ``adjust_contrast`` takes the mean of a
whole image, which XLA and PyTorch sum in different orders (a last-bit
difference in a few pixels), and the noise op then puts each pixel back on
the uint8 grid with ``floor(x * 255) / 255``. Where a pixel lies within that
last bit of a grid line, the two packages land one grid step apart. So a
recipe with colour jitter and noise agrees to 1e-5 everywhere but in such
pixels, which must be at most one in a thousand and at most one grid step
apart (1/255 over the bank's smallest standard deviation).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuwsi.preprocess import augment as JA
from tpuwsi.preprocess import recipes as JR
from tpuwsi_torch.preprocess import augment as TA
from tpuwsi_torch.preprocess import recipes as TR
from tpuwsi_torch.preprocess.normalize import STD

TOL = dict(atol=1e-5, rtol=1e-5)
B, S = 5, 24
KEY = jax.random.PRNGKey(3)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the images are small, and the test runner's other
    workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    x = rng.random((B, S, S, 3), dtype=np.float32)
    x[1] = x[1].mean()          # a gray image: zero saturation, hue undefined
    x[2, ..., 1:] = x[2, ..., :1]  # r == g == b
    return x


# -- one op's draw from its key, as the JAX op makes it ---------------------------------

def _draw(name, key, shape, ranges=None):
    """The value the JAX op ``name`` draws from ``key`` for one image of ``shape``."""
    h, w = shape[0], shape[1]
    if name == "jitter":
        keys = jax.random.split(key, 4)
        return [float(jax.random.uniform(k, (), minval=r[0], maxval=r[1]))
                for k, r in zip(keys, ranges)]
    if name == "blur":
        return float(jax.random.uniform(key, (), minval=JR.BLUR_SIGMA[0],
                                        maxval=JR.BLUR_SIGMA[1]))
    if name == "noise":
        ks, kn = jax.random.split(key)
        return (float(jax.random.uniform(ks, (), minval=JR.NOISE_SIGMA[0],
                                         maxval=JR.NOISE_SIGMA[1])),
                np.array(jax.random.normal(kn, shape, jnp.float32)))
    if name in ("vflip", "hflip"):
        return bool(jax.random.bernoulli(key, 0.5))
    if name == "mean_pixel":
        return bool(jax.random.bernoulli(key, 0.75))
    if name == "rot90":
        return int(jax.random.randint(key, (), 0, 4))
    if name == "zoom":
        return float(jax.random.uniform(key, (), minval=1.0, maxval=1.0 + JR.SCALE_FACTOR))
    if name == "cutout":
        ky, kx = jax.random.split(key)
        return int(jax.random.randint(ky, (), 0, h)), int(jax.random.randint(kx, (), 0, w))
    raise KeyError(name)


def _stack(name, per_image):
    """Per-image draws → the port's batched form."""
    if name == "jitter":
        return [torch.tensor([d[i] for d in per_image]) for i in range(4)]
    if name == "noise":
        return (torch.tensor([d[0] for d in per_image]),
                torch.from_numpy(np.stack([d[1] for d in per_image])))
    if name == "cutout":
        return (torch.tensor([d[0] for d in per_image]), torch.tensor([d[1] for d in per_image]))
    return torch.tensor(per_image)


# -- each op --------------------------------------------------------------------------

OPS = {
    "blur": (lambda k, im: JA.gaussian_blur3(k, im, JR.BLUR_SIGMA),
             lambda im, d: TA.gaussian_blur3(im, JR.BLUR_SIGMA, sigma=d)),
    "noise": (lambda k, im: JA.gaussian_noise(k, im, JR.NOISE_SIGMA),
              lambda im, d: TA.gaussian_noise(im, JR.NOISE_SIGMA, stdev=d[0], noise=d[1])),
    "vflip": (JA.random_vflip, lambda im, d: TA.random_vflip(im, flip=d)),
    "hflip": (JA.random_hflip, lambda im, d: TA.random_hflip(im, flip=d)),
    "rot90": (JA.random_rot90, lambda im, d: TA.random_rot90(im, k=d)),
    "zoom": (lambda k, im: JA.random_zoom(k, im, (1.0, 1.0 + JR.SCALE_FACTOR)),
             lambda im, d: TA.random_zoom(im, scale=d)),
    "cutout": (lambda k, im: JA.cutout(k, im, 10, fill=0.0),
               lambda im, d: TA.cutout(im, 10, 0.0, centre=d)),
    "mean_pixel": (JA.mean_pixel_regularization,
                   lambda im, d: TA.mean_pixel_regularization(im, replace=d)),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_with_shared_draws_matches_jax(images, name):
    jop, top = OPS[name]
    keys = jax.random.split(jax.random.fold_in(KEY, len(name)), B)
    want = np.asarray(jax.vmap(jop)(keys, jnp.asarray(images)))
    per_image = [_draw(name, k, images.shape[1:]) for k in keys]
    got = top(torch.from_numpy(images), _stack(name, per_image))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if name in ("vflip", "hflip", "rot90", "mean_pixel"):
        assert len(set(map(str, per_image))) > 1, "the draws should not all agree"
    d = per_image[0]  # one unbatched image
    one = top(torch.from_numpy(images[0]),
              (d[0], torch.from_numpy(d[1])) if name == "noise" else d)
    np.testing.assert_allclose(one.numpy(), want[0], **TOL)


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_rot90_is_numpys_rot90(images, k):
    got = TA.random_rot90(torch.from_numpy(images), k=torch.full((B,), k))
    np.testing.assert_array_equal(got.numpy(), np.rot90(images, k, axes=(1, 2)))


def test_rot90_refuses_non_square_images():
    with pytest.raises(ValueError, match="square"):
        TA.random_rot90(torch.zeros(2, 4, 6, 3), k=torch.ones(2, dtype=torch.int64))


# -- the twelve recipes -----------------------------------------------------------------

_FIXED = JA.jitter_params(brightness=(0.85, 1.15), contrast=(0.75, 1.25), saturation=0.1,
                          hue=(-0.1, 0.1))
# the order of each recipe's key split (tpuwsi/preprocess/recipes.py) by draw name
SPLITS = {
    "flip": ["vflip", "hflip"],
    "rvf": ["rot90", "vflip"],
    "cbnfrsc": ["jitter", "blur", "noise", "vflip", "rot90", "zoom"],
    "cbnfrs": ["jitter", "blur", "noise", "vflip", "rot90", "zoom"],
    "pcbnfrsc": ["jitter", "blur", "noise", "vflip", "rot90", "zoom"],
    "pcbnfrs": ["jitter", "blur", "noise", "vflip", "rot90", "zoom"],
    "cbnfr": ["jitter", "blur", "noise", "vflip", "rot90"],
    "bnfrsc": ["blur", "noise", "vflip", "rot90", "zoom"],
    "bnfrs": ["blur", "noise", "vflip", "rot90", "zoom"],
    "frs": ["vflip", "rot90", "zoom"],
    "aug_receptornet": ["jitter", "hflip", "rot90", "cutout", "mean_pixel"],
    "none": [],
}


def _jitter_ranges(name, color_param):
    if name.startswith("pcbnfr"):
        return JA.jitter_params(brightness=color_param, contrast=color_param * 2,
                                saturation=color_param, hue=color_param)
    if name == "aug_receptornet":
        return JA.jitter_params(brightness=64.0 / 255, contrast=0.75, saturation=0.25,
                                hue=0.04)
    return _FIXED


def _replayed_draws(name, key, shape, color_param):
    keys = jax.random.split(key, B)
    order = SPLITS[name]
    per_image = {n: [] for n in order}
    for k in keys:
        if len(order) == 0:
            continue
        sub = jax.random.split(k, len(order))
        for n, kk in zip(order, sub):
            per_image[n].append(_draw(n, kk, shape, _jitter_ranges(name, color_param)))
    draws = {n: _stack(n, d) for n, d in per_image.items()}
    if name in TR.POST_NORM_CUTOUT:
        draws["cutout"] = _stack("cutout", [_draw("cutout", jax.random.fold_in(k, 7), shape)
                                            for k in keys])
    return draws


def test_recipe_names_and_constants_match_jax():
    assert TR.RECIPE_NAMES == JR.RECIPE_NAMES
    assert set(SPLITS) == set(JR.RECIPE_NAMES)
    assert (TR.SCALE_FACTOR, TR.BLUR_SIGMA, TR.NOISE_SIGMA, TR.CUTOUT_LEN) == \
        (JR.SCALE_FACTOR, JR.BLUR_SIGMA, JR.NOISE_SIGMA, JR.CUTOUT_LEN)
    for name in JR.RECIPE_NAMES:
        assert [n for n, _ in TR.recipe_ops(name)] == SPLITS[name]


@pytest.mark.parametrize("name", JR.RECIPE_NAMES)
def test_train_recipe_with_shared_draws_matches_jax(images, name):
    u8 = (images * 255).astype(np.uint8)
    size = 112  # past the 100-px cutout, so its hole lies inside the image
    u8 = np.repeat(np.repeat(u8, size // S + 1, axis=1), size // S + 1, axis=2)[:, :size, :size]
    color_param = 0.15
    want = np.asarray(JR.make_recipe(name, train=True, tile_size=size, color_param=color_param)(
        KEY, jnp.asarray(u8)))
    draws = _replayed_draws(name, KEY, u8.shape[1:], color_param)
    fn = TR.make_recipe(name, train=True, tile_size=size, color_param=color_param)
    got = fn(torch.from_numpy(u8), draws=draws)
    assert got.dtype == torch.float32 and got.shape == want.shape
    got = got.numpy()
    if "jitter" in SPLITS[name] and "noise" in SPLITS[name]:
        step = 1 / 255 / min(STD["Ron"]) + TOL["atol"]
        off = np.abs(got - want) > TOL["atol"] + TOL["rtol"] * np.abs(want)
        assert off.mean() <= 1e-3 and np.abs(got - want).max() <= step, \
            (off.sum(), np.abs(got - want).max())
        got = np.where(off, want, got)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", ["pcbnfrsc", "aug_receptornet", "flip"])
def test_recipe_draws_from_its_generator(name):
    u8 = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (3, 128, 128, 3),
                                                            dtype=np.uint8))
    fn = TR.make_recipe(name, train=True)
    a = fn(u8, torch.Generator().manual_seed(5))
    b = fn(u8, torch.Generator().manual_seed(5))
    c = fn(u8, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all()


def test_own_draws_stay_in_their_ranges():
    g = torch.Generator().manual_seed(0)
    img = torch.rand(400, 8, 8, 3, generator=g)
    turned = TA.random_rot90(img, generator=g)
    which = torch.stack([(turned == torch.rot90(img, k, dims=(1, 2))).flatten(1).all(1)
                         for k in range(4)], dim=1)
    assert (which.sum(1) == 1).all() and (which.float().mean(0) > 0.15).all()
    flips = (TA.random_vflip(img, generator=g) != img).flatten(1).any(1).float().mean()
    assert 0.4 < float(flips) < 0.6
    kept = (TA.mean_pixel_regularization(img, generator=g) == img).flatten(1).all(1)
    assert 0.15 < float(kept.float().mean()) < 0.35
    cut = TA.cutout(torch.ones(400, 8, 8, 1), 4, 0.0, generator=g)
    holes = (cut == 0).flatten(1).sum(1)
    assert holes.min() >= 4 and holes.max() <= 16
    noisy = TA.gaussian_noise(img, (0.0, 0.05), generator=g)
    assert noisy.min() >= 0 and noisy.max() <= 1 and torch.equal(noisy * 255,
                                                                  torch.floor(noisy * 255))


def test_timm_and_unknown_recipes_are_refused():
    with pytest.raises(NotImplementedError, match="M3b"):
        TR.make_recipe("timm", train=True)
    with pytest.raises(ValueError, match="unknown"):
        TR.make_recipe("nope", train=False)
