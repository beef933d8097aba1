"""Model compositions in PyTorch (counterpart of
``segmif_tpu/models/network.py``): the segmentation model, its
ImageNet-normalising wrapper, and the joint fuse-then-segment pipeline.

Module names follow the reference state dicts: a ``SegmentationNetwork``
holds ``denoise_net.{encoder,decoder,classifier}`` (Network3 / WeTr), and a
``FusionNetwork`` the Fusion_Network3_ac keys, so ``JointPipeline.seg`` and
``JointPipeline.fusion`` state dicts load into the JAX models through
``segmif_tpu.train.checkpoint.load_torch_{seg,fusion}_network``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from ..ops.color import recombine_fused, rgb_to_ycrcb
from ..ops.image import nchw, nhwc, normalize_imagenet
from .fusion import FusionNetwork
from .mit import MIT_VARIANTS, MixVisionTransformer
from .segformer_head import SegFormerHead


class SegModel(nn.Module):
    """MiT encoder + SegFormer decode head (+ the aux 1x1 classifier on
    stage 4, whose output only ``return_cam`` computes)."""

    def __init__(self, backbone: str = "mit_b3", num_classes: int = 9,
                 embedding_dim: int = 256):
        super().__init__()
        cfg = MIT_VARIANTS[backbone]
        self.encoder = MixVisionTransformer(cfg)
        self.decoder = SegFormerHead(cfg.embed_dims, num_classes,
                                     embedding_dim)
        self.classifier = nn.Conv2d(cfg.embed_dims[3], num_classes, 1,
                                    bias=False)

    def forward(self, x: torch.Tensor, return_cam: bool = False,
                train: bool = False, gen: Optional[torch.Generator] = None):
        """``train=True``: drop-path, dropout and batch statistics, with
        masks drawn from ``gen``; otherwise deterministic."""
        feats = self.encoder(x, train=train, gen=gen)
        logits = self.decoder(feats, train, gen)
        if return_cam:
            return logits, nhwc(self.classifier(nchw(feats[-1])))
        return logits

    def encode_taps_raw(self, x: torch.Tensor):
        """Stage-1/2 features at native resolution; stages 3-4 are not run."""
        feats = self.encoder(x, stages=2)
        return feats[0], feats[1]


class SegmentationNetwork(nn.Module):
    """[0,1] RGB in, 1/4-res class logits out (Network3)."""

    def __init__(self, backbone: str = "mit_b3", num_classes: int = 9,
                 embedding_dim: int = 256):
        super().__init__()
        self.denoise_net = SegModel(backbone, num_classes, embedding_dim)

    @property
    def dtype(self) -> torch.dtype:
        return self.denoise_net.classifier.weight.dtype

    def forward(self, rgb01: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """``train=True`` runs the train-mode model (``SegModel``); the
        default is deterministic, as serving and the frozen seg network of
        the fusion step run it."""
        return self.denoise_net(normalize_imagenet(rgb01).to(self.dtype),
                                train=train, gen=gen)

    def encode_taps_raw(self, rgb01: torch.Tensor):
        """Taps of the RAW [0,1] guide: no x255 / ImageNet normalisation,
        as the reference's forward_fusion is fed."""
        return self.denoise_net.encode_taps_raw(rgb01.to(self.dtype))


class JointPipeline(nn.Module):
    """Fuse, then segment the fused image. ``seg`` carries the Network3
    checkpoint's weights, ``fusion`` the Fusion_Network3_ac checkpoint's.
    ``quant`` is the fusion DRDBs' precision mode ("none" | "calibrate";
    "int8" through ``set_quant`` after calibrating, as
    ``serving.quantize_for_serving`` does). ``interaction`` picks the
    fusion net's variant (``FusionNetwork``; the deep tail, as the JAX
    pipeline builds it)."""

    def __init__(self, backbone: str = "mit_b3", num_classes: int = 9,
                 embedding_dim: int = 256, quant: str = "none",
                 interaction: str = "both"):
        super().__init__()
        self.seg = SegmentationNetwork(backbone, num_classes, embedding_dim)
        self.fusion = FusionNetwork(
            tap_channels=MIT_VARIANTS[backbone].embed_dims[:2], quant=quant,
            interaction=interaction)

    def set_quant(self, mode: str) -> None:
        """The fusion DRDBs' mode: "none" | "calibrate" | "int8"."""
        self.fusion.set_quant(mode)

    def guide_taps_raw(self, guide_rgb: torch.Tensor):
        return self.seg.encode_taps_raw(guide_rgb)

    def fuse(self, ir: torch.Tensor, vis_rgb: torch.Tensor,
             guide_rgb: Optional[torch.Tensor] = None,
             taps: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
             vis_channel: str = "r"):
        """ir [B,H,W,1], vis_rgb [B,H,W,3] in [0,1]. The guide defaults to
        vis_rgb; ``taps=`` replaces the guide-encoder pass. vis_channel 'r'
        feeds the R plane to the VIS branch (the reference's inference
        behaviour), 'y' the Y plane (its training behaviour).
        Returns (fused_rgb in [0,1], fused_y)."""
        if vis_channel not in ("r", "y"):
            raise ValueError(f"vis_channel must be 'r' or 'y', "
                             f"got {vis_channel!r}")
        if taps is None:
            taps = self.seg.encode_taps_raw(
                vis_rgb if guide_rgb is None else guide_rgb)
        vis_ycrcb = rgb_to_ycrcb(vis_rgb)
        vis_in = vis_rgb[..., 0:1] if vis_channel == "r" \
            else vis_ycrcb[..., 0:1]
        fused_y = self.fusion(ir, vis_in, taps[0], taps[1])
        return recombine_fused(fused_y, vis_ycrcb), fused_y

    def forward(self, ir: torch.Tensor, vis_rgb: torch.Tensor,
                guide_rgb: Optional[torch.Tensor] = None,
                taps: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                vis_channel: str = "r"):
        """Returns (fused_rgb, fused_y, seg logits at 1/4 resolution)."""
        fused_rgb, fused_y = self.fuse(ir, vis_rgb, guide_rgb, taps,
                                       vis_channel)
        return fused_rgb, fused_y, self.seg(fused_rgb)


def _trunc_normal(shape, std: float, gen: torch.Generator) -> torch.Tensor:
    """Normal(0, std) truncated to +-2 std, by the inverse CDF."""
    cdf = lambda z: 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))  # noqa: E731
    lo, hi = cdf(-2.0), cdf(2.0)
    u = torch.rand(shape, generator=gen, dtype=torch.float64)
    z = torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0) * math.sqrt(2.0)
    return (z * std).float()


@torch.no_grad()
def init_params(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Random weights from a seeded CPU generator, with the JAX package's
    initialisers: Linear weights truncated-normal(0.02), conv weights
    normal(sqrt(2 / fan_out)), zero biases, unit norm scales, PReLU 0.25."""
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            mod.weight.copy_(_trunc_normal(mod.weight.shape, 0.02, gen))
        elif isinstance(mod, nn.Conv2d):
            fan_out = mod.out_channels * mod.kernel_size[0] * \
                mod.kernel_size[1]
            w = torch.randn(mod.weight.shape, generator=gen)
            mod.weight.copy_(w * math.sqrt(2.0 / fan_out))
        elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d)):
            mod.reset_parameters()
            continue
        elif isinstance(mod, nn.PReLU):
            mod.weight.fill_(0.25)
        if getattr(mod, "bias", None) is not None:
            mod.bias.zero_()
    return model
