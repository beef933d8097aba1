"""Batched augmentation on the device (counterpart of
``segmif_tpu/data/augment.py``), plain PyTorch.

The reference augments on CPU workers: random scale 0.5-2.0 (bilinear
image, nearest label), a joint horizontal flip, a random crop padded with
zeros (ignore_index in the label) and rejected up to 10 times for class
balance (cat_max_ratio 0.75), and the photometric distortion on the
visible image only (brightness +-32, contrast and saturation 0.5-1.5, hue
+-18 in HSV). As in the JAX package, scale, flip, pad and crop are ONE
warp gather with static output shapes:

    dst pixel i  ->  src coord (flip applied)  via  (o + i + 0.5)/s - 0.5

with out-of-bounds filled by 0 (images) / ignore_index (labels). The 10
candidate crops are evaluated together and the first acceptable one is
taken, else the last.

The random draws are split from the maths: ``draw(gen, batch, cfg)``
takes every random number of a batch from a ``torch.Generator`` (on the
device when the batch is), and ``apply(draws, ...)`` is deterministic.
``augment_batch`` is the two in a row. Everything is batched: no host
loop over samples, and no value is read back to the host.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from ..utils.determinism import integer_exact

# the photometric coins of ``draw``, in the order of their columns
COINS = ("brightness", "contrast", "saturation", "hue", "contrast_first")


class AugConfig(NamedTuple):
    crop_size: int = 320
    scale_min: float = 0.5
    scale_max: float = 2.0
    flip_prob: float = 0.5
    cat_max_ratio: float = 0.75
    crop_tries: int = 10
    ignore_index: int = 255
    brightness_delta: float = 32.0
    contrast_range: tuple = (0.5, 1.5)
    saturation_range: tuple = (0.5, 1.5)
    hue_delta: float = 18.0


def draw(gen: torch.Generator, batch: int, cfg: AugConfig,
         dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """Every random number of one batch's augmentation, on ``gen``'s
    device: per sample the scale, the flip, the crop candidates' uniforms
    [crop_tries, 2] (row, column), the photometric coins [len(COINS)] and
    values (brightness shift ``beta``, contrast ``alpha``, saturation
    ``sat``, ``hue`` shift)."""
    dev = gen.device

    def u(*shape):
        return torch.rand(shape, generator=gen, device=dev, dtype=dtype)

    def uniform(lo, hi):
        return lo + u(batch) * (hi - lo)

    return {"scale": uniform(cfg.scale_min, cfg.scale_max),
            "flip": u(batch) < cfg.flip_prob,
            "crop_u": u(batch, cfg.crop_tries, 2),
            "coins": u(batch, len(COINS)) < 0.5,
            "beta": uniform(-cfg.brightness_delta, cfg.brightness_delta),
            "alpha": uniform(*cfg.contrast_range),
            "sat": uniform(*cfg.saturation_range),
            "hue": uniform(-cfg.hue_delta, cfg.hue_delta)}


# ------------------------------------------------------------------ warp ----

def _warp_coords(crop: int, scale, off_h, off_w, flip, src_h: int,
                 src_w: int):
    """Source coordinates [..., crop] of the fused scale -> flip -> crop
    transform; scale, offsets and flip are [...]."""
    i = torch.arange(crop, dtype=scale.dtype, device=scale.device)
    rows = (off_h[..., None] + i + 0.5) / scale[..., None] - 0.5
    cols = (off_w[..., None] + i + 0.5) / scale[..., None] - 0.5
    cols = torch.where(flip[..., None], (src_w - 1) - cols, cols)
    return rows, cols


def _take(img: torch.Tensor, r: torch.Tensor, c: torch.Tensor):
    """img [B, H, W, ...] at rows r [B, ..., S] x cols c [B, ..., S] ->
    [B, ..., S, S, ...] (indices clipped to the image)."""
    h, w = img.shape[1], img.shape[2]
    b = torch.arange(img.shape[0], device=img.device).view(
        -1, *([1] * r.ndim))
    return img[b, r.clamp(0, h - 1)[..., :, None],
               c.clamp(0, w - 1)[..., None, :]]


def _gather_bilinear(img: torch.Tensor, rows, cols, fill: float = 0.0):
    """img [B, H, W, C]; rows, cols [B, S] -> [B, S, S, C], bilinear, with
    ``fill`` outside the source extent."""
    h, w = img.shape[1], img.shape[2]
    r0, c0 = torch.floor(rows), torch.floor(cols)
    fr = (rows - r0)[:, :, None, None]
    fc = (cols - c0)[:, None, :, None]
    r0i, c0i = r0.long(), c0.long()
    v00 = _take(img, r0i, c0i)
    v01 = _take(img, r0i, c0i + 1)
    v10 = _take(img, r0i + 1, c0i)
    v11 = _take(img, r0i + 1, c0i + 1)
    out = ((1 - fr) * (1 - fc) * v00 + (1 - fr) * fc * v01
           + fr * (1 - fc) * v10 + fr * fc * v11)
    inside = (((rows >= -0.5) & (rows <= h - 0.5))[:, :, None, None]
              & ((cols >= -0.5) & (cols <= w - 0.5))[:, None, :, None])
    return torch.where(inside, out, torch.full_like(out, fill))


def _gather_nearest(lab: torch.Tensor, rows, cols, fill_value: int):
    """lab [B, H, W] int; rows, cols [B, ..., S] -> [B, ..., S, S],
    nearest (round half to even), with ``fill_value`` outside."""
    h, w = lab.shape[1], lab.shape[2]
    ri, ci = torch.round(rows).long(), torch.round(cols).long()
    out = _take(lab, ri, ci)
    inside = (((ri >= 0) & (ri <= h - 1))[..., :, None]
              & ((ci >= 0) & (ci <= w - 1))[..., None, :])
    return torch.where(inside, out, torch.full_like(out, fill_value))


# -------------------------------------------------------- crop selection ----

def _pick_crop_offsets(draws, lab, cfg: AugConfig, num_classes: int):
    """The offsets [B] (rows, cols) of the first of the crop candidates
    whose most frequent class covers less than cat_max_ratio of the valid
    label pixels, else of the last candidate (get_random_cropbox)."""
    b, src_h, src_w = lab.shape
    scale, flip = draws["scale"], draws["flip"]
    # negative when the scaled image is smaller than the crop: the image
    # then lands at a random place on the padded canvas
    offs_h = draws["crop_u"][..., 0] * (scale * src_h - cfg.crop_size)[:, None]
    offs_w = draws["crop_u"][..., 1] * (scale * src_w - cfg.crop_size)[:, None]
    tries = offs_h.shape[1]
    rows, cols = _warp_coords(cfg.crop_size, scale[:, None].expand_as(offs_h),
                              offs_h, offs_w, flip[:, None].expand_as(offs_h),
                              src_h, src_w)
    crops = _gather_nearest(lab, rows, cols, cfg.ignore_index)
    # ignored and out-of-range labels go to bin num_classes, not counted
    idx = torch.where((crops != cfg.ignore_index) & (crops < num_classes),
                      crops, torch.full_like(crops, num_classes))
    idx = idx.clamp_min(0).reshape(b * tries, -1)
    cnt = torch.zeros((b * tries, num_classes + 1), dtype=torch.int64,
                      device=lab.device)
    with integer_exact():   # exact in any order
        cnt.scatter_add_(1, idx, torch.ones_like(idx))
    cnt = cnt[:, :num_classes].reshape(b, tries, num_classes)
    total = cnt.sum(-1).clamp_min(1)
    ratio = cnt.max(-1).values.to(scale.dtype) / total.to(scale.dtype)
    ok = ratio < cfg.cat_max_ratio
    first_ok = ok.to(torch.int32).argmax(dim=1)
    pick = torch.where(ok.any(dim=1), first_ok,
                       torch.full_like(first_ok, tries - 1)).long()[:, None]
    return offs_h.gather(1, pick)[:, 0], offs_w.gather(1, pick)[:, 0]


# ----------------------------------------------------------- photometric ----

def _rgb_to_hsv(rgb):
    """[..., 3] in [0,255] -> (h in [0,360), s in [0,1], v in [0,255])."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn
    one = torch.ones_like(d)
    safe_d = torch.where(d == 0, one, d)
    h = torch.where(
        mx == r, (g - b) / safe_d % 6.0,
        torch.where(mx == g, (b - r) / safe_d + 2.0, (r - g) / safe_d + 4.0))
    h = torch.where(d == 0, torch.zeros_like(h), h * 60.0)
    s = torch.where(mx == 0, torch.zeros_like(d),
                    d / torch.where(mx == 0, one, mx))
    return h, s, mx


def _hsv_to_rgb(h, s, v):
    c = v * s
    hp = h / 60.0
    x = c * (1.0 - torch.abs(hp % 2.0 - 1.0))
    m = v - c
    z = torch.zeros_like(c)
    conds = [
        (hp < 1, (c, x, z)), (hp < 2, (x, c, z)), (hp < 3, (z, c, x)),
        (hp < 4, (z, x, c)), (hp < 5, (x, z, c)), (hp >= 5, (c, z, x)),
    ]
    r = g = b = z
    done = torch.zeros_like(c, dtype=torch.bool)
    for cond, (rr, gg, bb) in conds:
        use = cond & ~done
        r = torch.where(use, rr, r)
        g = torch.where(use, gg, g)
        b = torch.where(use, bb, b)
        done = done | cond
    return torch.stack([r + m, g + m, b + m], dim=-1)


def photometric_distortion(img255: torch.Tensor, draws):
    """mmseg-style photometric jitter of [B, H, W, 3] images in [0, 255],
    per sample: brightness, contrast (before or after the colour ops, by
    the ``contrast_first`` coin), saturation, hue; in float throughout."""
    coin = {k: draws["coins"][:, i].view(-1, 1, 1, 1)
            for i, k in enumerate(COINS)}
    per = {k: draws[k].view(-1, 1, 1, 1) for k in
           ("beta", "alpha", "sat", "hue")}
    img = img255
    img = torch.where(coin["brightness"],
                      torch.clamp(img + per["beta"], 0, 255), img)
    mode, do_contrast = coin["contrast_first"], coin["contrast"]
    img = torch.where(mode & do_contrast,
                      torch.clamp(img * per["alpha"], 0, 255), img)
    h, s, v = _rgb_to_hsv(img)
    s = torch.where(coin["saturation"][..., 0],
                    torch.clamp(s * per["sat"][..., 0], 0.0, 1.0), s)
    h = torch.where(coin["hue"][..., 0], (h + per["hue"][..., 0] * 2.0)
                    % 360.0, h)
    img = _hsv_to_rgb(h, s, v)
    img = torch.where(~mode & do_contrast,
                      torch.clamp(img * per["alpha"], 0, 255), img)
    return torch.clamp(img, 0.0, 255.0)


# ------------------------------------------------------------- full aug ----

def apply(draws: Dict[str, torch.Tensor], ir, vis, guide, label,
          cfg: AugConfig, num_classes: int) -> Dict[str, torch.Tensor]:
    """One batch -> cropped and augmented tensors, with the given draws.

    ir/vis/guide: [B, H, W, 3] in [0, 255] (uint8 or float); label:
    [B, H, W] int. Returns {'ir' [B,C,C,1], 'vis'/'guide' [B,C,C,3] in
    [0,1] (the draws' float dtype), 'label' [B,C,C] int64}."""
    dt = draws["scale"].dtype
    ir, vis, guide = (t.to(dt) for t in (ir, vis, guide))
    label = label.long()
    src_h, src_w = label.shape[1], label.shape[2]
    off_h, off_w = _pick_crop_offsets(draws, label, cfg, num_classes)
    rows, cols = _warp_coords(cfg.crop_size, draws["scale"], off_h, off_w,
                              draws["flip"], src_h, src_w)
    vis = photometric_distortion(vis, draws)
    # reference passes mean_rgb = [0, 0, 0] as the image fill
    return {"ir": _gather_bilinear(ir[..., 0:1], rows, cols) / 255.0,
            "vis": _gather_bilinear(vis, rows, cols) / 255.0,
            "guide": _gather_bilinear(guide, rows, cols) / 255.0,
            "label": _gather_nearest(label, rows, cols, cfg.ignore_index)}


def augment_batch(gen: torch.Generator, ir, vis, guide, label,
                  cfg: AugConfig, num_classes: int,
                  dtype: torch.dtype = torch.float32):
    """``apply(draw(gen, B, cfg, dtype), ...)``: the batch on ``gen``'s
    device, augmented in ``dtype``."""
    return apply(draw(gen, ir.shape[0], cfg, dtype), ir, vis, guide, label,
                 cfg, num_classes)
