"""Row halos and whole-image gathers for strip-sharded window losses.

Counterpart of `gaussianeditor_tpu/parallel/halo.py` (`halo_exchange_rows`,
`ssim_sum_sharded`, `ssim_sharded`, `gather_rows`). An image is split
into equal row strips, rank i of `group` holding rows [i*hs, (i+1)*hs).
A window loss at a strip's edge needs rows of its neighbours:

* SSIM (11x11 window, radius 5): `halo_exchange_rows` extends each strip
  with `halo` rows from each neighbour (true image edges zero-filled, as
  the whole image's zero padding), and a rows-VALID SSIM map of the
  extended strip equals the whole image's map on the strip's rows.
* LPIPS (VGG16, a receptive field of about 212 px): a halo would ship
  more rows than the strips themselves, so `gather_rows` reassembles the
  whole image on every rank; the caller divides the loss by the group
  size so that the sum over ranks counts each image once.

Each exchange is a `torch.autograd.Function` over collectives of
`group`, forward and backward: `gather_rows` is one `all_gather`, its
backward an `all_reduce(SUM)` of the cotangent and a slice of the rank's
own rows (the psum-scatter of the JAX VJP); `halo_exchange_rows` is one
`all_gather` of every rank's top and bottom `halo` rows, and its
backward one `all_gather` of the halos' cotangents, each returned to the
rank that sent the rows. Only `all_gather` and `all_reduce` are used:
gloo takes CUDA tensors for those (its transport stages them through
the host), not for `reduce_scatter` or point-to-point sends. Every rank
of `group` must make the same calls in the same order.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

from gaussianeditor_tpu_torch.train.losses import ssim_map


def _all_gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return parts


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[0]
        return torch.cat(_all_gather(x, group), dim=0)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        r = dist.get_rank(ctx.group)
        return g[r * ctx.rows:(r + 1) * ctx.rows], None


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Reassemble the whole image from row strips: [hs, W, ...] on each
    rank -> [n*hs, W, ...] on every rank. Differentiable: a rank's strip
    receives the sum over ranks of the cotangents of its rows."""
    return _GatherRows.apply(x, group)


class _HaloRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, halo, group):
        n, i = dist.get_world_size(group), dist.get_rank(group)
        ctx.halo, ctx.group = halo, group
        parts = _all_gather(torch.cat([x[:halo], x[-halo:]], dim=0), group)
        top = parts[i - 1][halo:] if i > 0 else torch.zeros_like(x[:halo])
        bot = parts[i + 1][:halo] if i < n - 1 else torch.zeros_like(x[:halo])
        return torch.cat([top, x, bot], dim=0)

    @staticmethod
    def backward(ctx, g):
        h, group = ctx.halo, ctx.group
        n, i = dist.get_world_size(group), dist.get_rank(group)
        parts = _all_gather(torch.cat([g[:h], g[-h:]], dim=0), group)
        dx = g[h:-h].clone()
        if i > 0:       # my top rows were rank i-1's bottom halo
            dx[:h] += parts[i - 1][h:]
        if i < n - 1:   # my bottom rows were rank i+1's top halo
            dx[-h:] += parts[i + 1][:h]
        return dx, None, None


def halo_exchange_rows(x: torch.Tensor, halo: int, group=None
                       ) -> torch.Tensor:
    """Extend a strip [hs, W, ...] with `halo` rows from each neighbour in
    `group` (rank i-1's last rows above, rank i+1's first rows below);
    the first strip's top and the last strip's bottom are zeros, as the
    whole image's zero padding. hs must be at least `halo`."""
    if x.shape[0] < halo:
        raise ValueError(f"a strip of {x.shape[0]} rows cannot give a halo "
                         f"of {halo}")
    return _HaloRows.apply(x, halo, group)


class _SumOverRanks(torch.autograd.Function):
    """all_reduce(SUM) of a value; its backward hands each rank the
    cotangent of the sum for its own term (the sum is replicated, and
    each rank differentiates it once)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.detach().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def ssim_sum_sharded(pred: torch.Tensor, target: torch.Tensor, group=None,
                     window_size: int = 11) -> torch.Tensor:
    """The sum of the SSIM map over this rank's strip rows, exact across
    strip edges (halo-extended rows-VALID map). Its sum over the ranks,
    divided by H*W*C, is the whole image's mean SSIM."""
    h = window_size // 2
    p = halo_exchange_rows(pred, h, group)
    t = halo_exchange_rows(target, h, group)
    return torch.sum(ssim_map(p, t, window_size, rows="VALID"))


def ssim_sharded(pred: torch.Tensor, target: torch.Tensor, group=None,
                 window_size: int = 11) -> torch.Tensor:
    """The whole image's mean SSIM of a row-strip-sharded pair [hs, W, C]
    (all strips of equal height), on every rank; equals
    `losses.ssim` of the gathered images to float tolerance, and so do
    its gradients."""
    s = _SumOverRanks.apply(
        ssim_sum_sharded(pred, target, group, window_size), group)
    return s / (dist.get_world_size(group) * pred.numel())
