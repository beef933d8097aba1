"""The weights crossing: JAX ``JointPipeline`` variables -> the port's
``state_dict`` (the inverse of ``segmif_tpu/train/checkpoint.py``'s
``convert_mit_encoder`` / ``convert_segformer_head`` /
``load_torch_*_network``).

Plain numpy in, torch out; no JAX import. Layout rules:
 - Dense kernel [in, out] -> Linear weight [out, in];
 - conv kernel HWIO -> OIHW (the depthwise [3,3,1,C] -> [C,1,3,3] alike);
 - LayerNorm / BatchNorm scale -> weight;
 - BatchNorm batch_stats mean / var -> running_mean / running_var.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _dense(p: Mapping, key: str, out: StateDict) -> None:
    out[key + "weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[key + "bias"] = _t(p["bias"])


def _conv(p: Mapping, key: str, out: StateDict) -> None:
    out[key + "weight"] = _t(np.transpose(np.asarray(p["kernel"]),
                                          (3, 2, 0, 1)))
    if "bias" in p:
        out[key + "bias"] = _t(p["bias"])


def _norm(p: Mapping, key: str, out: StateDict) -> None:
    out[key + "weight"] = _t(p["scale"])
    out[key + "bias"] = _t(p["bias"])


def mit_state_dict_from_jax(enc: Mapping, prefix: str = "") -> StateDict:
    """MixVisionTransformer params -> ``patch_embed1.proj.weight``,
    ``block1.0.attn.q.weight``, ... (under ``prefix``)."""
    out: StateDict = {}
    for name, p in enc.items():
        m = re.fullmatch(r"block(\d)_(\d+)", name)
        if m:
            base = f"{prefix}block{m[1]}.{m[2]}."
            _norm(p["norm1"], base + "norm1.", out)
            _norm(p["norm2"], base + "norm2.", out)
            attn = p["attn"]
            for sub in ("q", "kv", "proj"):
                _dense(attn[sub], f"{base}attn.{sub}.", out)
            if "sr" in attn:
                _conv(attn["sr"], base + "attn.sr.", out)
                _norm(attn["norm"], base + "attn.norm.", out)
            _dense(p["mlp"]["fc1"], base + "mlp.fc1.", out)
            _dense(p["mlp"]["fc2"], base + "mlp.fc2.", out)
            _conv(p["mlp"]["dwconv"], base + "mlp.dwconv.dwconv.", out)
        elif name.startswith("patch_embed"):
            _conv(p["proj"], f"{prefix}{name}.proj.", out)
            _norm(p["norm"], f"{prefix}{name}.norm.", out)
        elif re.fullmatch(r"norm\d", name):
            _norm(p, f"{prefix}{name}.", out)
        else:
            raise KeyError(f"unexpected MiT param {name!r}")
    return out


def seg_state_dict_from_jax(params: Mapping, batch_stats: Mapping,
                            prefix: str = "") -> StateDict:
    """SegmentationNetwork variables ({'seg': {encoder, decoder,
    classifier}} and {'seg': {'decoder': {'bn': {mean, var}}}}) ->
    ``denoise_net.*`` keys (under ``prefix``)."""
    seg = params["seg"]
    base = prefix + "denoise_net."
    out = mit_state_dict_from_jax(seg["encoder"], base + "encoder.")
    dec = seg["decoder"]
    d = base + "decoder."
    for i in (1, 2, 3, 4):
        _dense(dec[f"linear_c{i}"], f"{d}linear_c{i}.proj.", out)
    _conv(dec["linear_fuse"], d + "linear_fuse.conv.", out)
    _norm(dec["bn"], d + "linear_fuse.bn.", out)
    stats = batch_stats["seg"]["decoder"]["bn"]
    out[d + "linear_fuse.bn.running_mean"] = _t(stats["mean"])
    out[d + "linear_fuse.bn.running_var"] = _t(stats["var"])
    out[d + "linear_fuse.bn.num_batches_tracked"] = torch.tensor(0)
    _conv(dec["linear_pred"], d + "linear_pred.", out)
    _conv(seg["classifier"], base + "classifier.", out)
    return out


def fusion_state_dict_from_jax(params: Mapping,
                               prefix: str = "") -> StateDict:
    """FusionNetwork params (interaction 'both', deep tail) -> the
    Fusion_Network3_ac keys (under ``prefix``)."""
    out: StateDict = {}
    out[prefix + "relu.weight"] = _t(np.reshape(params["prelu_alpha"], (1,)))
    names = {"seg_proj1": "conv3", "seg_proj2": "conv4"}
    for name in ("conv1_ir", "conv1_vis", "conv2", "conv21", "conv22",
                 "seg_proj1", "seg_proj2"):
        _conv(params[name], prefix + names.get(name, name) + ".", out)
    for n in (1, 2, 3, 4):
        drdb = params[f"drdb{n}"]
        for i in range(1, 6):
            _conv(drdb[f"dconv{i}"], f"{prefix}DRDB{n}.Dcov{i}.", out)
        _conv(drdb["bottleneck"], f"{prefix}DRDB{n}.conv.", out)
    cross = params["ffm"]["cross"]
    c = prefix + "ffm.cross."
    for i in (1, 2, 3):
        _dense(cross[f"channel_proj{i}"], f"{c}channel_proj{i}.", out)
    for i in (1, 2):
        _dense(cross[f"end_proj{i}"], f"{c}end_proj{i}.", out)
        _norm(cross[f"norm{i}"], f"{c}norm{i}.", out)
    _dense(cross["cross_attn"]["kv_seg"], c + "cross_attn.kv3.", out)
    _dense(cross["cross_attn2"]["kv1"], c + "cross_attn2.kv1.", out)
    _dense(cross["cross_attn2"]["kv2"], c + "cross_attn2.kv2.", out)
    return out


def load_quant_from_jax(model, quant: Mapping) -> None:
    """JAX ``variables['quant']`` (the calibrated amaxes,
    ``['fusion']['drdb{n}']['amax']``, numpy) -> ``DRDB{n}.amax`` of the
    port ``JointPipeline`` ``model``'s fusion net, on the model's device.
    Call ``model.set_quant("int8")`` after it to quantise with them."""
    fusion = quant["fusion"]
    for n, drdb in enumerate(model.fusion.drdbs(), start=1):
        amax = _t(np.reshape(fusion[f"drdb{n}"]["amax"], (6,)))
        drdb.amax.copy_(amax)


def state_dict_from_jax(params: Mapping, batch_stats: Mapping) -> StateDict:
    """JAX JointPipeline variables (``variables['params']``,
    ``variables['batch_stats']`` as numpy arrays) -> the port
    ``JointPipeline.state_dict()``: ``seg.denoise_net.*`` and
    ``fusion.*``."""
    out = seg_state_dict_from_jax(params["seg"], batch_stats["seg"], "seg.")
    out.update(fusion_state_dict_from_jax(params["fusion"], "fusion."))
    return out
