"""The port's 3x3 / stride 2 / pad 1 max pool (``paddle_tpu_torch/kernels/
pool.py``) against the JAX package's (``paddle_tpu/kernels/pool.py``).

The same numpy inputs go through ``_maxpool_bwd_pallas(...,
interpret=True)`` (the Pallas kernel in interpret mode, as
``tests/test_pool_kernel.py`` runs it), ``_pool_fwd_raw`` and
``jax.grad`` of ``maxpool_3x3s2p1(x, True)``, and through the port's
plain backward and Function on the CPU. Tolerance rtol/atol 1e-6 (the
JAX test's own); the forward is compared bit for bit (a max is exact),
the all-ties case exactly.

The kernel runs only on a card: the ``cuda`` tests hold it against the
plain version there, bit for bit (``chip_smoke.py`` does so at the ResNet
stem's shape).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.pool import (_maxpool_bwd_pallas, _pool_fwd_raw,
                                     maxpool_3x3s2p1 as jax_maxpool)

from paddle_tpu_torch import kernels as tkernels
from paddle_tpu_torch.kernels import pool as tp
from paddle_tpu_torch.utils.error import Error

TOL = dict(rtol=1e-6, atol=1e-6)


def _case(shape, seed, grid=False):
    """x [B, H, W, C] (randn, or on the grid 0..3 so most windows tie) and
    dy [B, H/2, W/2, C]."""
    r = np.random.RandomState(seed)
    x = (r.randint(0, 4, shape) if grid else r.randn(*shape)).astype(
        np.float32)
    dy = r.randn(shape[0], shape[1] // 2, shape[2] // 2, shape[3]).astype(
        np.float32)
    return x, dy


def _jax_bwd(x, dy):
    return np.asarray(_maxpool_bwd_pallas(jnp.asarray(x), jnp.asarray(dy),
                                          interpret=True))


def _port_bwd(x, dy):
    return tp.maxpool_3x3s2p1_bwd(torch.from_numpy(x),
                                  torch.from_numpy(dy)).numpy()


@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (1, 12, 16, 128),
                                   (3, 6, 10, 64)])
def test_plain_backward_matches_the_pallas_kernel(shape):
    x, dy = _case(shape, seed=0)
    np.testing.assert_allclose(_port_bwd(x, dy), _jax_bwd(x, dy), **TOL)


@pytest.mark.parametrize("shape", [(2, 6, 8, 3), (1, 4, 6, 48)])
def test_channels_off_the_lane_width(shape):
    """C = 3 and 48, outside JAX's C % 64 gate: its kernel's interpret
    mode takes them, and the port's plain version agrees."""
    x, dy = _case(shape, seed=1)
    np.testing.assert_allclose(_port_bwd(x, dy), _jax_bwd(x, dy), **TOL)


def test_all_ties_get_the_full_gradient():
    """One window, four equal inputs: every one gets dy (the reference's
    `in == out`), exactly."""
    x = np.zeros((1, 2, 2, 64), np.float32)
    dy = np.ones((1, 1, 1, 64), np.float32)
    np.testing.assert_array_equal(_port_bwd(x, dy), np.ones_like(x))


def test_grid_values_tie_as_in_jax():
    """Values on 0..3: most windows tie, and overlapping windows credit
    a shared maximum twice or four times."""
    x, dy = _case((2, 8, 10, 16), seed=2, grid=True)
    got = _port_bwd(x, dy)
    np.testing.assert_allclose(got, _jax_bwd(x, dy), **TOL)
    assert (got != 0).mean() > 0.3


def test_nan_window_gives_no_gradient_as_in_jax():
    """One NaN in x: its windows' maxima are NaN (jnp.maximum), so no
    position in them gets a gradient; the rest as before."""
    x, dy = _case((1, 8, 8, 4), seed=3)
    x[0, 3, 4, 1] = np.nan
    got, want = _port_bwd(x, dy), _jax_bwd(x, dy)
    np.testing.assert_allclose(got, want, **TOL)
    assert not np.isnan(got).any()
    assert (got[0, 2:5, 3:6, 1] == 0).all()


def test_forward_equals_reduce_window():
    x, _ = _case((2, 8, 8, 64), seed=4)
    x[1, 2, 3, 5] = np.nan
    got = tp.maxpool_3x3s2p1(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(_pool_fwd_raw(
        jnp.asarray(x))))


def test_autograd_gradient_matches_jax_grad():
    """tests/test_pool_kernel.py's end-to-end case: sum(pool(x)**2)."""
    x, _ = _case((2, 6, 6, 64), seed=2)
    want = jax.grad(lambda x: jnp.sum(jax_maxpool(x, True) ** 2))(
        jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    (tp.maxpool_3x3s2p1(tx) ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", [(1, 7, 8, 64), (1, 8, 9, 64),
                                   (8, 8, 64)])
def test_shapes_off_the_geometry_raise(shape):
    x = torch.zeros(shape)
    with pytest.raises(Error, match="maxpool_3x3s2p1_supported"):
        tp.maxpool_3x3s2p1(x)
    with pytest.raises(Error, match="maxpool_3x3s2p1_supported"):
        tp.maxpool_3x3s2p1_bwd(x, x)


def test_dy_shape_is_checked():
    with pytest.raises(Error, match="dy must be"):
        tp.maxpool_3x3s2p1_bwd(torch.zeros(1, 4, 4, 2), torch.zeros(1, 4, 4, 2))


def test_hopper_predicate():
    """The Hopper kernel's predicate keeps the function's geometry (NHWC,
    every size >= 1, H and W even: HO = H/2), adds the kernel's 32-bit
    numbering of the 2 x 2 blocks (B * HO * WO * C < 2**31), and drops
    JAX's two TPU clauses, C % 64 == 0 (the lanes of a vector register)
    and one image fitting VMEM: a thread a 2 x 2 block needs neither."""
    assert tp.maxpool_3x3s2p1_supported((256, 112, 112, 64))
    assert tp.maxpool_3x3s2p1_supported((1, 8, 8, 48))        # JAX: no
    assert tp.maxpool_3x3s2p1_supported((1, 512, 512, 256))   # JAX: no
    assert tp.maxpool_3x3s2p1_supported((1, 2, 2, 1))
    assert not tp.maxpool_3x3s2p1_supported((1, 7, 7, 64))    # odd H/W
    assert not tp.maxpool_3x3s2p1_supported((1, 8, 7, 64))
    assert not tp.maxpool_3x3s2p1_supported((0, 8, 8, 64))
    assert not tp.maxpool_3x3s2p1_supported((1, 8, 8, 0))
    assert not tp.maxpool_3x3s2p1_supported((8, 8, 64))
    assert tp.maxpool_3x3s2p1_supported((2**13 - 1, 512, 512, 4))
    assert not tp.maxpool_3x3s2p1_supported((2**13, 512, 512, 4))  # 2**31


def test_shapes_past_the_kernels_index_raise():
    """2**31 blocks of 2 x 2: refused at the call, on any device (a meta
    tensor holds the shape without the 32 GiB)."""
    x = torch.empty(2**13, 512, 512, 4, device="meta")
    with pytest.raises(Error, match="2\\*\\*31"):
        tp.maxpool_3x3s2p1(x)


def test_wrapper_refuses_non_cuda_devices():
    x = torch.empty(1, 4, 4, 8, device="meta")
    dy = torch.empty(1, 2, 2, 8, device="meta")
    before = dict(tkernels.launches)
    with pytest.raises(Error, match="no kernel for device"):
        tp.maxpool_3x3s2p1_bwd(x, dy)
    with pytest.raises(Error, match="no kernel for device"):
        tp.maxpool_3x3s2p1(x)
    assert tkernels.launches == before


@pytest.mark.parametrize("shape,offsets,plan", [
    ((2, 8, 8, 3), (0, 0, 0), tp.THREAD),            # C % 4 != 0
    ((2, 16, 12, 48), (0, 0, 0), tp.STRIP),
    ((2, 8, 8, 64), (0, 0, 0), tp.STRIP),
    ((2, 8, 8, 64), (4, 0, 0), tp.THREAD),           # x off 16 bytes
    ((2, 16, 12, 48), (0, 8, 0), tp.THREAD),         # dy off 16 bytes
    ((256, 112, 112, 64), (0, 0, 0), tp.STRIP),      # the report shape
])
def test_bwd_plan_from_shape_and_pointers(shape, offsets, plan):
    """The strip kernel where C % 4 == 0 and x, dy and dx are 16-byte
    aligned (its float4s and cp.async need both), the thread kernel
    otherwise; the pointers are those of a 4 KiB-aligned buffer plus the
    offsets."""
    assert tp.maxpool_bwd_plan(shape, [4096 * (i + 1) + o for i, o in
                                       enumerate(offsets)]) == plan


def test_bwd_plan_takes_the_thread_kernel_for_a_misaligned_view():
    """A contiguous view one float into its buffer: the data pointer the
    wrapper passes is 4 bytes past a 16-byte boundary."""
    x = torch.zeros(2 * 8 * 8 * 64 + 1)[1:].view(2, 8, 8, 64)
    dy = torch.zeros(2, 4, 4, 64)
    dx = torch.empty(2, 8, 8, 64)
    ptrs = [x.data_ptr(), dy.data_ptr(), dx.data_ptr()]
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    assert tp.maxpool_bwd_plan(x.shape, ptrs) == tp.THREAD


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the port's CUDA kernels)")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,grid", [((2, 8, 8, 64), False),
                                        ((3, 6, 10, 3), False),
                                        ((2, 16, 12, 48), True)])
def test_kernel_equals_plain_on_the_card(shape, grid):
    _needs_card()
    x, dy = _case(shape, seed=5, grid=grid)
    x[0, 1, 1, 0] = np.nan
    tx, tdy = torch.from_numpy(x).cuda(), torch.from_numpy(dy).cuda()
    got = tp.maxpool_3x3s2p1_bwd(tx, tdy)
    want = tp.maxpool_3x3s2p1_bwd_plain(tx, tdy)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2, 2, 4), (2, 18, 26, 64),
                                   (2, 12, 20, 100), (1, 6, 34, 8)])
def test_strip_kernel_equals_plain_on_the_card(shape):
    """The strip kernel at the smallest image, at HO and WO off its 8
    window columns a strip (edges of the strips and of the image), at a
    second, partial channel slice (C = 100) and at C = 8, with ties and a
    NaN: bit for bit."""
    _needs_card()
    x, dy = _case(shape, seed=7, grid=True)
    x[0, 1, 1, 0] = np.nan
    tx, tdy = torch.from_numpy(x).cuda(), torch.from_numpy(dy).cuda()
    got = tp.maxpool_3x3s2p1_bwd(tx, tdy)
    want = tp.maxpool_3x3s2p1_bwd_plain(tx, tdy)
    torch.cuda.synchronize()
    assert tp.last_plan == tp.STRIP
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_autograd_launches_the_kernel_once():
    _needs_card()
    x, _ = _case((2, 8, 8, 64), seed=6)
    tx = torch.tensor(x, device="cuda", requires_grad=True)
    tkernels.reset_launch_counts()
    tp.maxpool_3x3s2p1(tx).sum().backward()
    torch.cuda.synchronize()
    assert tkernels.launches["maxpool_bwd"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["permuted", "bf16"])
def test_unsupported_cuda_tensors_raise_at_the_call(kind):
    """A CUDA x the kernel does not take raises before the forward runs,
    not in backward()."""
    _needs_card()
    x = torch.zeros(1, 8, 4, 8, device="cuda")
    x = (x.permute(0, 2, 1, 3) if kind == "permuted"
         else x.to(torch.bfloat16)).requires_grad_(True)
    with pytest.raises(Error, match="maxpool_3x3s2p1: the kernel takes"):
        tp.maxpool_3x3s2p1(x)
