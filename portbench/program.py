"""The system under test, as the drivers take it from the port
(``segmif_tpu_torch``): the joint pipeline built at a configuration's
sizes and loaded with the benchmark's weights, and the layers whose
forwards the traced run marks. Only this module and the drivers import
the port."""
from __future__ import annotations

from typing import Dict, List

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_model(cfg: Dict, sd: Dict[str, torch.Tensor], device,
                dtype: torch.dtype):
    """``JointPipeline(backbone, classes)`` on ``device`` in ``dtype``,
    loaded with ``sd`` (strict: every name and shape of the configuration
    file must be the port's)."""
    from segmif_tpu_torch.models.mit import MIT_VARIANTS
    from segmif_tpu_torch.models.network import JointPipeline

    mit = MIT_VARIANTS[cfg["backbone"]]
    for key in ("embed_dims", "depths", "num_heads", "sr_ratios",
                "patch_sizes", "strides"):
        if list(getattr(mit, key)) != list(cfg[key]):
            raise ValueError(f"{cfg['name']}: {key} {cfg[key]} is not the "
                             f"port's {cfg['backbone']} ({getattr(mit, key)})")
    with torch.device(device):
        model = JointPipeline(cfg["backbone"], cfg["num_classes"],
                              cfg["decoder_dim"])
    model = model.to(dtype)
    model.load_state_dict(sd, strict=True)
    return model


def layers(model) -> Dict[str, List[torch.nn.Module]]:
    """The modules of each layer the traced run marks: the fusion net
    (``models/fusion.py``) and the seg network (``models/mit.py``'s
    encoder, in the guide's pass and the seg pass, and
    ``models/segformer_head.py``)."""
    net = model.seg.denoise_net
    return {"fusion": [model.fusion], "mit": [net.encoder, net.decoder]}
