"""Spatial (row) parallelism for the fusion network (counterpart of
``segmif_tpu/parallel/spatial.py``): the image's rows are split over the
ranks of a mesh, and each rank runs the fusion trunk on its row block.

 - Blocks are of uneven height where the rank count does not divide H
   (the first H % N ranks take one row more), with no pad rows, and each
   block holds at least ``HALO`` rows (else ``ValueError``). The JAX
   package pads H to a multiple of N and masks the pad rows in every conv
   through ``drdb_apply``'s ``valid_rows``; the port's DRDB kernels take no
   such mask, and need none: a block is extended by real rows only, and
   where a block edge is the image's top or bottom it gets no halo, so each
   conv's zero fill there is the image border, as on one device.
 - Convs and DRDBs see ``HALO`` = 16 rows of each neighbour (the reach of
   conv1 + a DRDB is 1 + 10, of a DRDB 10), cropped after; the tail's three
   3x3 convs see 3. Before conv1 the rows come from the input, which every
   rank holds whole; before DRDB3/4 and the tail they come from the
   neighbours (``Comm.exchange_rows``). Halo-extended blocks are built as
   NHWC concatenations, so their NCHW views are channels_last memory with
   16-byte pixel strides, the layout the DRDB kernels read.
 - The FFM runs pass A (``crosspath_grams``, the kernel on the card) on the
   rank's tokens, sums the f32 grams over the ranks (``all_reduce_grams``)
   and runs pass B (``crosspath_apply_rows``) on the rank's tokens with the
   contexts of the whole image: exact, as JAX's ``psum_axis`` is.
 - The seg taps are projected and upsampled to the full resolution as on
   one device (``FusionNetwork._tap``) and each rank takes its block's
   rows: every rank runs the whole guide encoder pass anyway.

``spatial_fuse_batched`` returns the whole fused Y on every rank (the
blocks gathered); ``spatial_fuse`` is the single-image form;
``make_spatial_fuse_fn`` is ``train.steps.make_fuse_fn`` with the trunk
row-sharded: the guide encoder pass and the YCrCb recombine run unsharded
on every rank, as in the JAX package. On the card each rank launches,
per batch, the FFM grams and apply kernels twice each and the DRDB growth
and tail kernels four times each. The trunk must be the deployed one
(interaction 'both', the deep tail, DRDBs in quant mode "none").
"""
from __future__ import annotations

import copy
from typing import List, Optional, Tuple

import torch

from .._device import place, resolve
from ..kernels import _build
from ..kernels.ffm import _crosspath_kernels
from ..ops.color import recombine_fused, rgb_to_ycrcb
from ..ops.image import nchw, nhwc
from .dist import Comm
from .mesh import Mesh

HALO = 16       # conv1 + DRDB (reach 11) and a DRDB (reach 10), as in JAX
TAIL_HALO = 3   # conv2, conv21, conv22
_CL = torch.channels_last


def row_blocks(h: int, n: int, halo: int = HALO) -> List[Tuple[int, int]]:
    """Rank r's rows [lo, hi) of an H-row image over n ranks: the first
    h % n blocks one row taller. Raises when a block would hold fewer
    than ``halo`` rows (the exchange reaches one neighbour only)."""
    if h // n < halo:
        raise ValueError(f"rows per shard {h // n} < halo {halo}; use "
                         f"fewer shards for H={h}")
    base, extra = divmod(h, n)
    bounds = [0]
    for r in range(n):
        bounds.append(bounds[-1] + base + (r < extra))
    return list(zip(bounds[:-1], bounds[1:]))


def all_reduce_grams(comm: Optional[Comm], grams: torch.Tensor):
    """The FFM grams of every rank's tokens, summed."""
    return grams if comm is None else comm.all_reduce_sum_(grams)


def _exchange(comm: Optional[Comm], x: torch.Tensor, halo: int):
    """x: [B, C, rows, W] (channels_last) -> (x with up to ``halo`` rows
    of each neighbour above and below, rows added above, rows added
    below); none at the image's top and bottom."""
    if comm is None or comm.world == 1:
        return x, 0, 0
    t = nhwc(x)
    shape = (t.shape[0], halo) + tuple(t.shape[2:])
    above, below = comm.exchange_rows(t[:, :halo], t[:, -halo:], shape,
                                      shape)
    parts = [p for p in (above, t, below) if p is not None]
    return (nchw(torch.cat(parts, dim=1)),
            0 if above is None else halo, 0 if below is None else halo)


def _crop(x: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
    return x[:, :, top:x.shape[2] - bottom].contiguous(memory_format=_CL)


def _ffm(fusion, comm, x1, x2, s):
    """One FFM round on this rank's tokens with the whole image's grams;
    [B, C, rows, W] channels_last in and out."""
    cross = fusion.ffm.cross
    b, c, h, w = x1.shape

    def tokens(t):
        return nhwc(t.contiguous(memory_format=_CL)).reshape(b, h * w, c)

    o1, o2 = _crosspath_kernels(
        tokens(x1), tokens(x2), tokens(s), cross.folded_weights(),
        cross.scale, cross.num_heads,
        reduce=lambda g: all_reduce_grams(comm, g))
    return (nchw(o1.reshape(b, h, w, c)), nchw(o2.reshape(b, h, w, c)))


def _check_trunk(fusion) -> None:
    if fusion.interaction != "both" or fusion.conv22 is None or \
            fusion.return_attention or \
            any(d.quant != "none" for d in fusion.drdbs()):
        raise ValueError("spatial_fuse runs the deployed trunk: interaction "
                         "'both', the deep tail, no return_attention, "
                         "DRDBs in quant mode 'none'")


def spatial_fuse_batched(mesh: Mesh, fusion, ir: torch.Tensor,
                         vis_y: torch.Tensor, tap1: torch.Tensor,
                         tap2: torch.Tensor, halo: int = HALO
                         ) -> torch.Tensor:
    """``fusion(ir, vis_y, tap1, tap2)`` (a ``FusionNetwork``) with the
    rows split over ``mesh``'s ranks. Every rank passes the whole inputs:
    ir, vis_y [B, H, W, >=1]; the taps NHWC at full or native resolution.
    Returns the whole fused Y [B, H, W, 1] on every rank."""
    _check_trunk(fusion)
    comm = mesh.comm
    n, r = (1, 0) if comm is None else (comm.world, comm.rank)
    h, w = ir.shape[1], ir.shape[2]
    blocks = row_blocks(h, n, max(halo, TAIL_HALO))
    lo, hi = blocks[r]
    dt = fusion.conv1_ir.weight.dtype

    def trunk(x, conv, drdb):
        # the halo rows of the input, which every rank holds whole
        a, b = max(lo - halo, 0), min(hi + halo, h)
        y = fusion._prelu(conv(nchw(x[:, a:b, :, 0:1].to(dt))))
        return _crop(drdb(y.contiguous(memory_format=_CL)), lo - a, b - hi)

    def drdb_halo(x, drdb):
        xh, top, bottom = _exchange(comm, x, halo)
        return _crop(drdb(xh), top, bottom)

    x1 = trunk(ir, fusion.conv1_ir, fusion.DRDB1)
    x2 = trunk(vis_y, fusion.conv1_vis, fusion.DRDB2)
    x1, x2 = _ffm(fusion, comm, x1, x2,
                  fusion._tap(tap1, fusion.conv3, (h, w))[:, :, lo:hi])
    x1 = drdb_halo(x1, fusion.DRDB3)
    x2 = drdb_halo(x2, fusion.DRDB4)
    x1, x2 = _ffm(fusion, comm, x1, x2,
                  fusion._tap(tap2, fusion.conv4, (h, w))[:, :, lo:hi])
    y, top, bottom = _exchange(comm, torch.cat([x1, x2], dim=1), TAIL_HALO)
    for conv in (fusion.conv2, fusion.conv21, fusion.conv22):
        y = fusion._prelu(conv(y))
    y = nhwc(y[:, :, top:y.shape[2] - bottom])
    if comm is None or comm.world == 1:
        return y
    # gathered in f32: exact for bf16, and a type every backend moves
    out = comm.all_gather_rows(y.float(), [b - a for a, b in blocks], dim=1)
    return out.to(y.dtype)


def spatial_fuse(mesh: Mesh, fusion, ir, vis_y, tap1, tap2,
                 halo: int = HALO) -> torch.Tensor:
    """``spatial_fuse_batched`` of one image: ir, vis_y [H, W, >=1], taps
    [h, w, C] -> the fused Y [H, W, 1]."""
    return spatial_fuse_batched(mesh, fusion, ir[None], vis_y[None],
                                tap1[None], tap2[None], halo)[0]


def make_spatial_fuse_fn(mesh: Mesh, model,
                         compute_dtype: torch.dtype = torch.bfloat16,
                         device=None, vis_channel: str = "r"):
    """``train.steps.make_fuse_fn`` with the fusion trunk row-sharded
    over ``mesh``: ``fuse(ir [B,H,W,1], vis [B,H,W,3], guide [B,H,W,3])
    -> (fused_rgb clipped to [0,1], fused_y)`` on every rank, through a
    copy of ``model`` (a ``JointPipeline``) made now, in
    ``compute_dtype`` and eval mode. The guide encoder pass and the
    recombine run unsharded on every rank. ``device=None`` means this
    rank's CUDA device (``resolve``)."""
    if vis_channel not in ("r", "y"):
        raise ValueError(f"vis_channel must be 'r' or 'y', got "
                         f"{vis_channel!r}")
    dev = resolve(device)
    acc = _build.acc_dtype(compute_dtype)
    infer = place(copy.deepcopy(model), dev).to(compute_dtype).eval()
    _check_trunk(infer.fusion)

    def fuse(ir, vis, guide):
        with torch.inference_mode():
            ir, vis, guide = (t.to(dev, acc) for t in (ir, vis, guide))
            tap1, tap2 = infer.seg.encode_taps_raw(guide)
            vis_ycrcb = rgb_to_ycrcb(vis)
            vis_in = vis[..., 0:1] if vis_channel == "r" \
                else vis_ycrcb[..., 0:1]
            fused_y = spatial_fuse_batched(mesh, infer.fusion, ir, vis_in,
                                           tap1, tap2)
            return recombine_fused(fused_y, vis_ycrcb), fused_y

    return fuse
