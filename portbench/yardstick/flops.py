"""Model FLOPs of a configuration, counted from its shapes whatever
implements them: 2 per multiply-add of every convolution, linear layer and
attention product the published equations need (elementwise work, norms,
softmax and resizes not counted).

 - ``mit_flops``: the MiT encoder's first ``stages`` stages on an H x W
   image (patch embeddings; per block the q, sr, kv and proj layers, the
   two attention products and the Mix-FFN);
 - ``head_flops``: SegFormer's decode head;
 - ``fusion_flops``: SegMiF's fusion net (entry convs, the DRDBs, the tap
   projections, two rounds of the FFM with its per-head contexts, the
   tail);
 - ``serve_flops_per_pair``: the guide's taps (stages 1-2), the fusion net
   and the seg pass (all four stages and the head);
 - ``train_flops_per_pair``: a fusion-phase step's model FLOPs per pair,
   forward x 3 for the trained fusion net, forward x 2 for the frozen seg
   net (the gradient of its input only) and forward x 1 for the guide's
   taps; recomputation is not counted.
"""
from __future__ import annotations

from typing import Dict, List, Tuple


def conv_out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def stage_sizes(cfg: Dict, h: int, w: int) -> List[Tuple[int, int]]:
    out = []
    for k, s in zip(cfg["patch_sizes"], cfg["strides"]):
        h, w = conv_out(h, k, s, k // 2), conv_out(w, k, s, k // 2)
        out.append((h, w))
    return out


def mit_flops(cfg: Dict, h: int, w: int, stages: int = 4) -> int:
    total, cin = 0, 3
    for i, (sh, sw) in enumerate(stage_sizes(cfg, h, w)[:stages]):
        e, k = cfg["embed_dims"][i], cfg["patch_sizes"][i]
        sr, hid = cfg["sr_ratios"][i], cfg["embed_dims"][i] * cfg["mlp_ratio"]
        n = sh * sw
        total += 2 * n * e * cin * k * k
        m = n if sr == 1 else (sh // sr) * (sw // sr)
        block = 2 * n * e * e              # q
        if sr > 1:
            block += 2 * m * e * e * sr * sr   # the sr conv
        block += 2 * m * e * 2 * e         # kv
        block += 4 * n * m * e             # q k^T and p v over the heads
        block += 2 * n * e * e             # proj
        block += 2 * n * e * hid * 2 + 2 * n * hid * 9   # Mix-FFN
        total += cfg["depths"][i] * block
        cin = e
    return total


def head_flops(cfg: Dict, h: int, w: int) -> int:
    sizes = stage_sizes(cfg, h, w)
    emb = cfg["decoder_dim"]
    total = sum(2 * sh * sw * e * emb
                for (sh, sw), e in zip(sizes, cfg["embed_dims"]))
    n1 = sizes[0][0] * sizes[0][1]
    return total + 2 * n1 * 4 * emb * emb + 2 * n1 * emb * cfg["num_classes"]


def drdb_flops(cfg: Dict, npix: int) -> int:
    ch, g = cfg["fusion_channels"], cfg["growth"]
    growth = sum(2 * npix * 9 * g * (ch + i * g) for i in range(5))
    return growth + 2 * npix * (ch + 5 * g) * ch


def ffm_flops(cfg: Dict, npix: int) -> int:
    """One round of the FFM over npix tokens: three channel projections
    (C -> 2C), three KV projections (C -> 2C), four per-head contexts
    (k_h^T v_h) and four applications (q_h ctx_h), two end projections
    (2C -> C)."""
    c, heads = cfg["fusion_channels"], cfg["ffm_heads"]
    d = c // heads
    proj = 6 * 2 * npix * c * 2 * c
    ctx = 4 * 2 * npix * heads * d * d
    apply = 4 * 2 * npix * heads * d * d
    return proj + ctx + apply + 2 * 2 * npix * 2 * c * c


def fusion_flops(cfg: Dict, h: int, w: int) -> int:
    ch, npix = cfg["fusion_channels"], h * w
    (h1, w1), (h2, w2) = stage_sizes(cfg, h, w)[:2]
    total = 2 * 2 * npix * ch * 9                     # entry convs
    total += cfg["drdbs"] * drdb_flops(cfg, npix)
    total += 2 * h1 * w1 * cfg["embed_dims"][0] * ch  # conv3 (native res)
    total += 2 * h2 * w2 * cfg["embed_dims"][1] * ch  # conv4
    total += cfg["ffm_rounds"] * ffm_flops(cfg, npix)
    total += 2 * npix * 9 * (2 * ch * ch + ch * ch // 2 + ch // 2)  # tail
    return total


def seg_flops(cfg: Dict, h: int, w: int) -> int:
    return mit_flops(cfg, h, w) + head_flops(cfg, h, w)


def serve_flops_per_pair(cfg: Dict) -> int:
    h, w = cfg["height"], cfg["width"]
    return (mit_flops(cfg, h, w, stages=2) + fusion_flops(cfg, h, w)
            + seg_flops(cfg, h, w))


def train_flops_per_pair(cfg: Dict) -> int:
    h, w = cfg["height"], cfg["width"]
    return (3 * fusion_flops(cfg, h, w) + 2 * seg_flops(cfg, h, w)
            + mit_flops(cfg, h, w, stages=2))
