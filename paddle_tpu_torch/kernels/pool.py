"""Max pool, kernel 3 / stride 2 / symmetric pad 1, NHWC, with a Hopper
kernel for its backward: the kernel's wrapper, its plain version and the
autograd Function that joins them.

Counterpart of ``paddle_tpu/kernels/pool.py`` ``maxpool_3x3s2p1`` (the
ResNet stem's pool, 112 -> 56) and its ``custom_vjp``. A library
function, as in the JAX package: no layer calls it. The forward is
``F.max_pool2d`` on the channels-last view, as the JAX package leaves its
forward to XLA's reduce_window. The backward is ``maxpool_bwd`` in
``csrc/pool.cu`` (its source note gives the design and the bound on an
H100): each input position sums ``dy * (x == window max)`` over the <= 4
windows that contain it, the maxima recomputed from x. Every tied position
gets the full gradient (the reference's hl_maxpool_backward), not torch's
first argmax; a window holding a NaN gives none, as ``jnp.maximum`` makes
its max NaN.

``maxpool_bwd`` has two kernels, chosen by :func:`maxpool_bwd_plan` from
the shape and the pointers: the strip kernel (a block a strip of window
columns, walking down the image, x and dy staged once in 16-byte vectors,
each window's max formed once) where C % 4 == 0 and the pointers are
16-byte aligned, and the thread kernel (a thread a 2 x 2 block of one
channel) for any other C or alignment.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from paddle_tpu_torch import kernels as _kernels
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.utils.error import enforce


def maxpool_3x3s2p1_supported(x_shape: Sequence[int]) -> bool:
    """Whether the function (and the kernel) takes x of this shape: NHWC
    with every size >= 1, H and W even, and B * H/2 * W/2 * C < 2**31.

    Even H and W are the function's own geometry (HO = H/2, which the JAX
    kernel's row-parity split assumes, and the plain version's too). The
    last clause is the thread kernel's indexing: a thread a 2 x 2 block of
    one channel, numbered in 32 bits (a float32 x of 32 GiB). JAX's gate
    also asks for C % 64 == 0 (the TPU's lane width) and for one image's
    buffers to fit VMEM; the Hopper kernels need neither: the thread
    kernel takes any C, and neither holds an image in a block's
    memory."""
    if len(x_shape) != 4:
        return False
    B, H, W, C = x_shape
    return (min(B, H, W, C) >= 1 and H % 2 == 0 and W % 2 == 0
            and B * (H // 2) * (W // 2) * C < 2**31)


def _check(where, x, dy=None) -> None:
    enforce(maxpool_3x3s2p1_supported(tuple(x.shape)),
            f"{where}: x must be NHWC with even H and W and fewer than "
            f"2**31 2 x 2 blocks (maxpool_3x3s2p1_supported), got "
            f"{list(x.shape)}")
    if dy is not None:
        B, H, W, C = x.shape
        enforce(tuple(dy.shape) == (B, H // 2, W // 2, C),
                f"{where}: dy must be {[B, H // 2, W // 2, C]}, got "
                f"{list(dy.shape)}")


def maxpool_3x3s2p1_fwd(x: torch.Tensor) -> torch.Tensor:
    """The pooled [B, H/2, W/2, C]: the max over each 3 x 3 window, stride
    2, padded with -inf (NaN propagates)."""
    _check("maxpool_3x3s2p1", x)
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel_size=3, stride=2,
                     padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def maxpool_3x3s2p1_bwd_plain(x: torch.Tensor, dy: torch.Tensor):
    """The kernel's function in PyTorch, the TPU kernel's parity form over
    the whole batch: dx [B, H, W, C] in dy's type, the math in float32."""
    B, H, W, C = x.shape
    HO, WO = H // 2, W // 2
    x = x.float()
    g = dy.float()
    inf = float("inf")
    # the pooled maxima: the 3-row max at each output row, then 3 columns
    x2 = x.reshape(B, HO, 2, W, C)
    xe, xo = x2[:, :, 0], x2[:, :, 1]                 # even / odd rows
    xo_up = torch.cat([x.new_full((B, 1, W, C), -inf), xo[:, :-1]], 1)
    rowmax = torch.maximum(torch.maximum(xe, xo), xo_up)
    r2 = rowmax.reshape(B, HO, WO, 2, C)
    re_, ro = r2[:, :, :, 0], r2[:, :, :, 1]
    ro_up = torch.cat([x.new_full((B, HO, 1, C), -inf), ro[:, :, :-1]], 2)
    y = torch.maximum(torch.maximum(re_, ro), ro_up)  # [B, HO, WO, C]

    # window row o+1, and column p+1: +inf maxima and 0 gradients past the
    # grid, so those terms are +0
    y_down = torch.cat([y[:, 1:], x.new_full((B, 1, WO, C), inf)], 1)
    g_down = torch.cat([g[:, 1:], g.new_zeros(B, 1, WO, C)], 1)

    def row_terms(x_rows, ys, gs):
        """One window row's terms for the input rows x_rows [B, HO, W, C]:
        an even column sees window p, an odd one p and p+1."""
        xp = x_rows.reshape(B, HO, WO, 2, C)
        xce, xco = xp[:, :, :, 0], xp[:, :, :, 1]
        t_e = gs * (xce == ys).to(gs.dtype)
        ys_r = torch.cat([ys[:, :, 1:], ys.new_full((B, HO, 1, C), inf)], 2)
        gs_r = torch.cat([gs[:, :, 1:], gs.new_zeros(B, HO, 1, C)], 2)
        t_o = gs * (xco == ys).to(gs.dtype) + gs_r * (xco == ys_r).to(gs.dtype)
        return torch.stack([t_e, t_o], 3).reshape(B, HO, W, C)

    dx_even = row_terms(xe, y, g)
    dx_odd = row_terms(xo, y, g) + row_terms(xo, y_down, g_down)
    return torch.stack([dx_even, dx_odd], 2).reshape(B, H, W, C).to(dy.dtype)


# maxpool_bwd's plans: the C entry's int
THREAD, STRIP = 0, 1
# the plan of the wrapper's last launch
last_plan: Optional[int] = None


def maxpool_bwd_plan(x_shape: Sequence[int], ptrs: Sequence[int]) -> int:
    """The plan ``maxpool_bwd`` launches for x of this shape with these
    data pointers (x, dy and dx): ``STRIP``, the strip kernel, where C % 4
    == 0 and every pointer is 16-byte aligned (its float4 loads, cp.async
    and stores need both); else ``THREAD``, the thread kernel, which takes
    any C and any alignment (C = 3, or a view that starts off a 16-byte
    boundary)."""
    C = x_shape[-1]
    aligned = all(p % 16 == 0 for p in ptrs)
    return STRIP if C % 4 == 0 and aligned else THREAD


_BWD = _build.GridKernel("maxpool_bwd", n_ptrs=3, source="pool", n_ints=5)


def maxpool_3x3s2p1_bwd(x: torch.Tensor, dy: torch.Tensor,
                        plan: Optional[int] = None) -> torch.Tensor:
    """dx [B, H, W, C]: the kernel, ``maxpool_bwd``, for CUDA tensors, in
    the plan :func:`maxpool_bwd_plan` gives (``plan`` forces one:
    ``THREAD``, or ``STRIP``, which raises where the channels or the
    pointers do not allow it), recorded in ``last_plan``;
    :func:`maxpool_3x3s2p1_bwd_plain` for CPU tensors."""
    global last_plan
    _check("maxpool_bwd", x, dy)
    if x.device.type == "cpu":
        return maxpool_3x3s2p1_bwd_plain(x, dy)
    _build.check_cuda_tensors("maxpool_bwd", [x, dy])
    dx = torch.empty_like(x)
    ptrs = [x.data_ptr(), dy.data_ptr(), dx.data_ptr()]
    chosen = maxpool_bwd_plan(x.shape, ptrs)
    if plan is None:
        plan = chosen
    enforce(plan == THREAD or (plan == STRIP and chosen == STRIP),
            f"maxpool_bwd: plan {plan} is not THREAD (0) or STRIP (1), or "
            f"STRIP without C % 4 == 0 and 16-byte aligned x, dy and dx "
            f"(C = {x.shape[-1]})")
    _BWD.launch(ptrs, *x.shape, plan, x.device)
    _kernels.launches["maxpool_bwd"] += 1
    last_plan = plan
    return dx


class _MaxPool(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return maxpool_3x3s2p1_fwd(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return maxpool_3x3s2p1_bwd(x, g.contiguous())


def maxpool_3x3s2p1(x: torch.Tensor) -> torch.Tensor:
    """Max pool, kernel 3 / stride 2 / symmetric pad 1, of x [B, H, W, C]
    (NHWC, H and W even) -> [B, H/2, W/2, C], differentiable in x through
    :func:`maxpool_3x3s2p1_bwd`. Shapes outside
    :func:`maxpool_3x3s2p1_supported` raise on any device; a tensor off
    the CPU that the kernel does not take (float32, contiguous, CUDA)
    raises here, before the forward."""
    _check("maxpool_3x3s2p1", x)
    if x.device.type != "cpu":
        _build.check_cuda_tensors("maxpool_3x3s2p1", [x])
    return _MaxPool.apply(x)
