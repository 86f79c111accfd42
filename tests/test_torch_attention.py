"""tpuwsi_torch.ops.attention held against tpuwsi.ops.attention.

Inputs come from a numpy seed, in fp32, and go through both packages. The
JAX side runs the Pallas ``_mha_qkv_kernel`` in interpret mode; the port's
wrapper runs its plain version on a CPU tensor. Tolerance 1e-5: the same
math in another summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuwsi.ops import attention as jattn
from tpuwsi_torch.ops import attention as tattn

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize(
    "b,n,heads,hd,block_len",
    [
        (2, 65, 2, 16, 0),   # just past the 64-token dispatch floor
        (2, 70, 2, 16, 0),   # ragged: 70 rows in a 128-row tile
        (2, 20, 2, 16, 5),   # packed: four 5-token sub-sequences
    ],
)
def test_mha_from_qkv_matches_pallas_kernel(b, n, heads, hd, block_len):
    rng = np.random.default_rng(n + block_len)
    x = rng.standard_normal((b, n, 3 * heads * hd), dtype=np.float32)
    ref = jattn.mha_from_qkv(jnp.asarray(x), heads, interpret=True, block_len=block_len)
    before = tattn.LAUNCHES
    out = tattn.mha_from_qkv(torch.from_numpy(x), heads, block_len=block_len)
    assert tattn.LAUNCHES == before  # a CPU tensor never reaches the kernel
    assert out.shape == (b, n, heads * hd) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_attention_reference_kv_lengths_matches_jax():
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((3, 2, 40, 16), dtype=np.float32) for _ in range(3))
    lengths = np.array([40, 17, 1], dtype=np.int32)
    ref = jattn.attention_reference(*map(jnp.asarray, (q, k, v)),
                                    kv_lengths=jnp.asarray(lengths))
    out = tattn.attention_reference(*map(torch.from_numpy, (q, k, v)),
                                    kv_lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize(
    "shape,heads,dtype,err",
    [
        ((2, 65, 3 * 128), 2, torch.float32, ValueError),    # not bf16
        ((2, 65, 3 * 96), 2, torch.bfloat16, ValueError),    # head_dim 48
        ((2, 512, 3 * 128), 2, torch.bfloat16, NotImplementedError),  # flash range
    ],
)
def test_kernel_rejects_what_it_does_not_take(shape, heads, dtype, err):
    with pytest.raises(err):
        tattn.check_kernel_input(torch.zeros(shape, dtype=dtype), heads)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,heads,block_len", [(8, 257, 6, 0), (6, 111, 6, 37)])
def test_kernel_matches_plain_on_card(b, n, heads, block_len):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn((b, n, 3 * heads * 64), generator=g, device="cuda").to(torch.bfloat16)
    before = tattn.LAUNCHES
    out = tattn.mha_from_qkv(qkv, heads, block_len=block_len)
    torch.cuda.synchronize()
    assert tattn.LAUNCHES == before + 1
    ref = tattn._mha_reference(qkv, heads, 64 ** -0.5, block_len)
    diff = (out.float() - ref.float()).abs()
    # bf16 rounding of q*scale and of p, fp32 accumulation
    assert diff.max().item() <= 2e-2 and diff.mean().item() <= 2e-3
