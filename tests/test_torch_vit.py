"""tpuwsi_torch's ViT held against the flax VisionTransformer.

Geometry: 64 px, patch 8 (65 tokens), dim 64, depth 2, 2 heads, fp32. The
flax model runs its Pallas attention in interpret mode; its parameters reach
the port through ``params_from_flax``. Tolerance 1e-4 on features and
logits: fp32 with LayerNorm and GEMM sums in another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuwsi.models import convert as jconvert
from tpuwsi.models import registry as jregistry
from tpuwsi.models import vit as jvit
from tpuwsi_torch.models import registry as tregistry
from tpuwsi_torch.models import vit as tvit
from tpuwsi_torch.models.convert import params_from_flax

GEOM = dict(img_size=64, patch_size=8, embed_dim=64, depth=2, num_heads=2)
TOL = dict(atol=1e-4, rtol=1e-4)


# 92 px at patch 4: 23 x 23 + 1 = 530 tokens, past the 512 from which the port
# takes the tiled flash pair; the flax model takes its plain attention there
LONG_GEOM = dict(GEOM, img_size=92, patch_size=4)


def _flax(num_classes=0, gelu_approx=False, scan_blocks=False, geom=GEOM, interpret=True):
    cfg = jvit.ViTConfig(
        **geom, num_classes=num_classes, dtype=jnp.float32,
        use_pallas_attention=True, pallas_interpret=interpret,
        gelu_approx=gelu_approx, scan_blocks=scan_blocks)
    model = jvit.VisionTransformer(cfg)
    x0 = jnp.zeros((1, geom["img_size"], geom["img_size"], 3), jnp.float32)
    variables = jax.device_get(model.init(jax.random.PRNGKey(0), x0))
    # non-trivial LayerNorm affine and biases (init leaves them 1 and 0)
    rng = np.random.default_rng(1)
    variables = jax.tree_util.tree_map(
        lambda v: v + 0.1 * rng.standard_normal(v.shape).astype(np.float32), variables)
    return model, variables


def _port(variables, num_classes=0, gelu_approx=False, geom=GEOM):
    cfg = tvit.ViTConfig(**geom, num_classes=num_classes, dtype=torch.float32,
                         gelu_approx=gelu_approx)
    model = tvit.VisionTransformer(cfg).eval()
    model.load_state_dict(params_from_flax(variables))
    return model


@pytest.mark.parametrize(
    "num_classes,gelu_approx,scan_blocks,img",
    [
        (0, False, False, 64),   # features, erf GELU, unrolled tree
        (2, True, False, 64),    # logits, tanh GELU
        (2, False, True, 64),    # scanned (stacked-depth) tree
        (0, False, False, 80),   # built at 64, fed 80: bicubic pos-embed resize
    ],
)
def test_vit_matches_flax(num_classes, gelu_approx, scan_blocks, img):
    model, variables = _flax(num_classes, gelu_approx, scan_blocks)
    x = np.random.default_rng(img).standard_normal((3, img, img, 3)).astype(np.float32)
    ref = jax.jit(model.apply)(variables, jnp.asarray(x))
    port = _port(variables, num_classes, gelu_approx)
    with torch.inference_mode():
        out = port(torch.from_numpy(x))
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("num_classes", [0, 2])
def test_long_sequence_vit_matches_flax(num_classes, monkeypatch):
    """530 tokens: features and logits through the port's flash pair."""
    from tpuwsi_torch.ops import attention as tattn

    model, variables = _flax(num_classes, geom=LONG_GEOM, interpret=False)
    x = np.random.default_rng(92).standard_normal((2, 92, 92, 3)).astype(np.float32)
    ref = jax.jit(model.apply)(variables, jnp.asarray(x))
    port = _port(variables, num_classes, geom=LONG_GEOM)
    assert port.pos_embed.shape == (1, 530, 64)
    calls = []
    real = tattn._flash_reference
    monkeypatch.setattr(tattn, "_flash_reference",
                        lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw))
    with torch.inference_mode():
        out = port(torch.from_numpy(x))
    assert calls == [(2, 2, 530, 32)] * LONG_GEOM["depth"]
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_converters_carry_a_long_sequence_tree():
    """The position table of a 530-token model crosses over and back whole."""
    from tpuwsi_torch.models.convert import params_to_flax

    _, variables = _flax(num_classes=2, geom=LONG_GEOM, interpret=False)
    sd = params_from_flax(variables)
    assert sd["pos_embed"].shape == (1, 530, 64)
    assert sd["patch_embed.proj.weight"].shape == (64, 3, 4, 4)
    back = params_to_flax(sd)["params"]
    np.testing.assert_array_equal(back["pos_embed"], variables["params"]["pos_embed"])
    np.testing.assert_array_equal(back["patch_embed"]["proj"]["kernel"],
                                  variables["params"]["patch_embed"]["proj"]["kernel"])
    ref = jconvert.flax_vit_to_torch(variables)
    assert sorted(sd) == sorted(ref)
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)


def test_registry_parses_the_448_px_model():
    model = tregistry.create_model("vit_small_patch16_448", num_classes=2)
    cfg = model.config
    assert (cfg.img_size, cfg.num_patches + 1, cfg.embed_dim, cfg.depth) == (448, 785, 384, 12)
    assert model.pos_embed.shape == (1, 785, 384)
    j = jregistry.parse_model_name("vit_small_patch16_448")
    assert (j.img_size, j.embed_dim, j.depth, j.num_heads) == (448, 384, 12, 6)


@pytest.mark.parametrize("scan_blocks", [False, True])
def test_params_from_flax_matches_jax_converter(scan_blocks):
    _, variables = _flax(num_classes=2, scan_blocks=scan_blocks)
    ref = jconvert.flax_vit_to_torch(variables)
    sd = params_from_flax(variables)
    assert sorted(sd) == sorted(ref)
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)


@pytest.mark.parametrize("grid", [10, 5])  # up- and downsampling an 8x8 grid
def test_interpolate_pos_encoding_matches_jax_resize(grid):
    pos = np.random.default_rng(grid).standard_normal((1, 65, 64)).astype(np.float32)
    ref = jvit.interpolate_pos_encoding(jnp.asarray(pos), grid * grid, grid, grid)
    out = tvit.interpolate_pos_encoding(torch.from_numpy(pos), grid * grid, grid, grid)
    assert out.shape == (1, 1 + grid * grid, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["vit_tiny_patch16_224", "vit_small_patch8_224_dino",
                                  "vit_base_patch16_384", "vit_large_patch14_224"])
def test_registry_geometry_matches_jax(name):
    j, t = jregistry.parse_model_name(name), tregistry.parse_model_name(name)
    for field in ("img_size", "patch_size", "embed_dim", "depth", "num_heads",
                  "mlp_ratio", "qkv_bias", "num_classes", "gelu_approx"):
        assert getattr(t, field) == getattr(j, field), field


@pytest.mark.parametrize("name,err", [("resnet50", NotImplementedError),
                                      ("efficientnet_b0", NotImplementedError),
                                      ("vit_huge_patch14_224", ValueError)])
def test_create_model_rejects_unported_and_unknown(name, err):
    with pytest.raises(err):
        tregistry.create_model(name)


def _drop_mask(shape, rate):
    """One keep mask per shape for both packages."""
    rng = np.random.default_rng(int(np.prod(shape)))
    return rng.random(tuple(shape), dtype=np.float32) >= rate


def test_attn_drop_rate_matches_flax_with_a_shared_mask(monkeypatch):
    """``attn_drop_rate``: dropout on the attention output before proj, in
    training only. Both packages draw their keep masks from ``_drop_mask``
    (no other dropout or stochastic depth is on, so every draw is this one);
    features and the gradient of the input at 1e-4."""
    rate = 0.25
    model, variables = _flax()
    jmodel = jvit.VisionTransformer(dataclasses.replace(model.config, attn_drop_rate=rate))
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(_drop_mask(shape, 1.0 - float(p))))
    x = np.random.default_rng(7).standard_normal((3, 64, 64, 3)).astype(np.float32)

    def jloss(xs, deterministic):
        out = jmodel.apply(variables, xs, deterministic=deterministic,
                           rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.sum(out ** 2), out

    (_, ref), ref_dx = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x), False)
    (_, ref_eval), _ = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x), True)

    draws = []

    def dropout(t, r, deterministic, generator):
        if deterministic or r == 0.0:
            return t
        draws.append((tuple(t.shape), r))
        keep = torch.from_numpy(_drop_mask(t.shape, r))
        return torch.where(keep, t / (1.0 - r), torch.zeros_like(t))

    monkeypatch.setattr(tvit, "_dropout", dropout)
    port = tvit.VisionTransformer(tvit.ViTConfig(**GEOM, dtype=torch.float32,
                                                 attn_drop_rate=rate))
    port.load_state_dict(params_from_flax(variables))
    xt = torch.from_numpy(x).requires_grad_()
    out = port(xt, deterministic=False, generator=torch.Generator().manual_seed(0))
    # its place in the draw order: one draw per block, on the attention output
    assert draws == [((3, 65, 64), rate)] * GEOM["depth"]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_dx), **TOL)
    assert not np.allclose(np.asarray(ref), np.asarray(ref_eval), atol=1e-3)
    with torch.inference_mode():
        np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(), np.asarray(ref_eval), **TOL)


def test_attn_dropout_draws_after_stochastic_depth_and_before_proj_dropout():
    """The documented draw order with every source of randomness on: the
    embedding mask, one (depth, 2, B) uniform for stochastic depth, then per
    block the attention-output mask, the proj mask and the two MLP masks."""
    cfg = tvit.ViTConfig(**GEOM, dtype=torch.float32, drop_rate=0.1, attn_drop_rate=0.2,
                         drop_path_rate=0.1)
    model = tvit.VisionTransformer(cfg)
    shapes = []
    real = torch.rand

    def rand(shape, **kw):
        shapes.append(tuple(shape))
        return real(shape, **kw)

    x = torch.zeros(2, 64, 64, 3)
    try:
        torch.rand = rand
        model(x, deterministic=False, generator=torch.Generator().manual_seed(0))
    finally:
        torch.rand = real
    tok, hid = (2, 65, 64), (2, 65, 256)
    assert shapes == [tok, (2, 2, 2)] + [tok, tok, hid, tok] * 2


@pytest.mark.parametrize("num_classes", [0, 2])
def test_return_all_tokens_matches_flax(num_classes):
    """``forward(..., return_all_tokens=True)``: the tokens after the final
    norm, head or not, 1e-4; row 0 of them is ``forward_features``."""
    model, variables = _flax(num_classes)
    x = np.random.default_rng(11).standard_normal((2, 64, 64, 3)).astype(np.float32)
    ref = model.apply(variables, jnp.asarray(x), return_all_tokens=True)
    port = _port(variables, num_classes)
    with torch.inference_mode():
        out = port(torch.from_numpy(x), return_all_tokens=True)
        feats = port.forward_features(torch.from_numpy(x))
    assert out.shape == ref.shape == (2, 65, 64)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_array_equal(out[:, 0].float().numpy(), feats.numpy())


def test_create_model_takes_the_reference_keywords():
    """The reference's ``create_model`` keywords reach the configuration;
    ``quant_int8``, not ported, raises by name; ``list_models`` names parse."""
    import inspect

    kw = dict(num_classes=3, drop_rate=0.1, drop_path_rate=0.2, img_size=64,
              attn_save_probs=True, bn_momentum=0.1, bn_eps=1e-5)
    j = jregistry.create_model("vit_tiny_patch16_224", dtype=jnp.float32, **kw).config
    t = tregistry.create_model("vit_tiny_patch16_224", dtype=torch.float32, **kw).config
    for field in ("num_classes", "drop_rate", "drop_path_rate", "img_size", "attn_save_probs",
                  "attn_drop_rate", "embed_dim", "depth", "num_heads"):
        assert getattr(t, field) == getattr(j, field), field
    jparams = inspect.signature(jregistry.create_model).parameters
    tparams = inspect.signature(tregistry.create_model).parameters
    renamed = {"use_pallas_attention": "use_kernel_attention"}
    assert [renamed.get(k, k) for k in jparams] == list(tparams)[:len(jparams)]
    assert list(tparams)[len(jparams):] == ["use_fused_mlp", "dense_pallas_bwd"]
    with pytest.raises(NotImplementedError, match="quant_int8"):
        tregistry.create_model("vit_tiny_patch16_224", quant_int8=True)
    # grad_checkpointing recomputes each block in the backward, as the reference's does
    assert tregistry.create_model("vit_tiny_patch16_224", grad_checkpointing=True).config.remat_blocks
    assert jregistry.create_model("vit_tiny_patch16_224", grad_checkpointing=True).config.remat_blocks
    names = tregistry.list_models()
    assert names and set(names) <= set(jregistry.list_models())
    assert [n for n in jregistry.list_models() if n.startswith("vit_")] == names
    for name in names:
        assert tregistry.parse_model_name(name) is not None
