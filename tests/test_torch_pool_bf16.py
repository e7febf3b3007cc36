"""The stem max pool's backward on bf16 (paddle_tpu_torch/kernels/pool.py
``maxpool_3x3s2p1_bwd`` and its bf16 kernel ``maxpool_bwd_bf16``) against
the JAX package's kernel on bf16.

The JAX reference is ``_maxpool_bwd_pallas(..., interpret=True)`` on bf16
x and dy: it reads them in their dtype, forms each window's max and
compares in float32, sums the <= 4 window terms in float32 and writes dx
once in dy's dtype. The port's plain version computes the same in float32
and rounds dx once, so the two are compared bit for bit. On the card the
``cuda`` tests hold ``maxpool_bwd_bf16`` against the plain version, bit
for bit (the kernel sums the terms in the plain version's order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.pool import _maxpool_bwd_pallas

from paddle_tpu_torch import kernels as tkernels
from paddle_tpu_torch.kernels import pool as tp
from paddle_tpu_torch.utils.error import Error

BF16 = torch.bfloat16


def _case(shape, seed, grid=False):
    """x [B, H, W, C] and dy [B, H/2, W/2, C] as bf16 tensors: x randn, or
    on the grid 0..3 so that most windows tie; dy randn."""
    r = np.random.RandomState(seed)
    x = (r.randint(0, 4, shape) if grid else r.randn(*shape)).astype(
        np.float32)
    dy = r.randn(shape[0], shape[1] // 2, shape[2] // 2, shape[3]).astype(
        np.float32)
    return torch.from_numpy(x).to(BF16), torch.from_numpy(dy).to(BF16)


def _jax_bwd(x, dy):
    """dx of the Pallas kernel in interpret mode on the same bf16 values,
    as a bf16 tensor."""
    jb = lambda a: jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)  # noqa
    dx = _maxpool_bwd_pallas(jb(x), jb(dy), interpret=True)
    assert dx.dtype == jnp.bfloat16
    return torch.from_numpy(np.asarray(dx.astype(jnp.float32))).to(BF16)


@pytest.mark.parametrize("shape,grid", [
    ((2, 8, 10, 16), False), ((2, 8, 10, 16), True), ((1, 12, 6, 64), False),
    ((3, 4, 4, 8), True), ((1, 6, 8, 3), False)])
def test_plain_bf16_backward_is_the_jax_kernel_bit_for_bit(shape, grid):
    """The plain version on bf16 x and dy: dx in bf16, bit-equal to the
    JAX kernel's on the same values, ties (the grid cases) included."""
    x, dy = _case(shape, seed=sum(shape), grid=grid)
    got = tp.maxpool_3x3s2p1_bwd(x, dy)
    assert got.dtype == BF16
    assert torch.equal(got, _jax_bwd(x, dy))


def test_float32_rounding_once_is_the_rule():
    """dx is the float32 sum rounded once: summing the window terms in
    bf16 (each add rounded) gives other bits somewhere on these inputs,
    so the comparison above tells the rule apart."""
    x, dy = _case((2, 8, 10, 16), seed=3, grid=True)
    want = _jax_bwd(x, dy)
    xf, gf = x.float(), dy.float()
    y = tp.maxpool_3x3s2p1_fwd(xf)
    terms = torch.zeros_like(xf, dtype=BF16)
    B, H, W, C = x.shape
    for o in range(H // 2):
        for p in range(W // 2):
            for r in range(max(2 * o - 1, 0), 2 * o + 2):
                for c in range(max(2 * p - 1, 0), 2 * p + 2):
                    hit = (xf[:, r, c] == y[:, o, p]).to(BF16)
                    terms[:, r, c] = terms[:, r, c] + hit * dy[:, o, p]
    assert not torch.equal(terms, want)


def test_function_keeps_bf16_on_the_cpu():
    """maxpool_3x3s2p1 on a bf16 CPU tensor: the forward in bf16 (the max
    of bf16 values), the saved tensor bf16 (nothing widened), dx in bf16
    equal to the plain version's."""
    x, dy = _case((2, 8, 8, 16), seed=5)
    xr = x.clone().requires_grad_(True)
    y = tp.maxpool_3x3s2p1(xr)
    assert y.dtype == BF16
    (saved,) = y.grad_fn.saved_tensors
    assert saved.dtype == BF16
    y.backward(dy)
    assert xr.grad.dtype == BF16
    assert torch.equal(xr.grad, tp.maxpool_3x3s2p1_bwd_plain(x, dy))


def _meta(shape, dtype=BF16):
    return torch.zeros(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("C,plan", [(12, None), (8, tp.THREAD)])
def test_bf16_form_refuses_what_it_does_not_take(C, plan):
    """The bf16 form is the strip kernel alone: C not a multiple of 8, or
    the thread plan forced, raises off the CPU (meta tensors here) and
    falls back to nothing."""
    x, dy = _meta((2, 8, 8, C)), _meta((2, 4, 4, C))
    with pytest.raises(Error, match="the bf16 form is the strip kernel"):
        tp.maxpool_3x3s2p1_bwd(x, dy, plan)


@pytest.mark.parametrize("dtypes", [(torch.float16,) * 2,
                                    (BF16, torch.float32)])
def test_other_dtypes_raise_off_the_cpu(dtypes):
    """float16 and a mix of dtypes raise before any kernel, naming the
    dtypes; a float16 x already in the forward."""
    x, dy = _meta((2, 8, 8, 16), dtypes[0]), _meta((2, 4, 4, 16), dtypes[1])
    with pytest.raises(Error, match="float32 tensors, or bfloat16"):
        tp.maxpool_3x3s2p1_bwd(x, dy)
    if x.dtype == torch.float16:
        with pytest.raises(Error, match="float32 tensors, or bfloat16"):
            tp.maxpool_3x3s2p1(x)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 112, 112, 64), (1, 8, 10, 16),
                                   (3, 6, 4, 8)])
def test_bf16_kernel_matches_plain_on_card(shape):
    """maxpool_bwd_bf16 against the plain version on the same bf16 values,
    bit for bit, one launch, the strip plan recorded."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    x, dy = _case(shape, seed=7, grid=True)
    before = tkernels.launches["maxpool_bwd_bf16"]
    got = tp.maxpool_3x3s2p1_bwd(x.cuda(), dy.cuda())
    assert tkernels.launches["maxpool_bwd_bf16"] == before + 1
    assert tp.last_plan == tp.STRIP
    assert torch.equal(got.cpu(), tp.maxpool_3x3s2p1_bwd_plain(x, dy))
