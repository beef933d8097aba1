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
from typing import Dict, List, Mapping

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
    """FusionNetwork params of any variant (every interaction, either
    tail) -> the port's keys (under ``prefix``): the Fusion_Network3_ac
    keys, ``att{i}.conv.{0,2}`` for the AttentionModules' ``conv_a`` /
    ``conv_b``, and ``cat_proj{1,2}_r{1,2}`` as the JAX package names the
    'concat' projections. Raises on a parameter it has no rule for."""
    out: StateDict = {}
    rest = dict(params)
    out[prefix + "relu.weight"] = _t(np.reshape(rest.pop("prelu_alpha"),
                                                (1,)))
    names = {"seg_proj1": "conv3", "seg_proj2": "conv4"}
    for name in ("conv1_ir", "conv1_vis", "conv2", "conv21", "conv22",
                 "seg_proj1", "seg_proj2", "cat_proj1_r1", "cat_proj2_r1",
                 "cat_proj1_r2", "cat_proj2_r2"):
        if name in rest:
            _conv(rest.pop(name), prefix + names.get(name, name) + ".", out)
    for n in (1, 2, 3, 4):
        drdb = rest.pop(f"drdb{n}")
        for i in range(1, 6):
            _conv(drdb[f"dconv{i}"], f"{prefix}DRDB{n}.Dcov{i}.", out)
        _conv(drdb["bottleneck"], f"{prefix}DRDB{n}.conv.", out)
    for i in range(1, 9):
        if f"att{i}" in rest:
            att = rest.pop(f"att{i}")
            _conv(att["conv_a"], f"{prefix}att{i}.conv.0.", out)
            _conv(att["conv_b"], f"{prefix}att{i}.conv.2.", out)
    if "ffm" in rest:
        cross = rest.pop("ffm")["cross"]
        c = prefix + "ffm.cross."
        for i in (1, 2, 3):
            _dense(cross[f"channel_proj{i}"], f"{c}channel_proj{i}.", out)
        for i in (1, 2):
            _dense(cross[f"end_proj{i}"], f"{c}end_proj{i}.", out)
            _norm(cross[f"norm{i}"], f"{c}norm{i}.", out)
        if "cross_attn" in cross:
            _dense(cross["cross_attn"]["kv_seg"], c + "cross_attn.kv3.", out)
        if "cross_attn2" in cross:
            for kv in ("kv1", "kv2"):
                _dense(cross["cross_attn2"][kv], f"{c}cross_attn2.{kv}.", out)
    if rest:
        raise KeyError(f"unexpected fusion params {sorted(rest)}")
    return out


def simple_fusion_state_dict_from_jax(params: Mapping,
                                      prefix: str = "") -> StateDict:
    """SimpleFusionNetwork params -> the port's keys (``conv1``,
    ``DRDB1``, ``DRDB2``, ``conv2``, ``relu.weight``)."""
    out: StateDict = {prefix + "relu.weight": _t(
        np.reshape(params["prelu_alpha"], (1,)))}
    for name in ("conv1", "conv2"):
        _conv(params[name], f"{prefix}{name}.", out)
    for n in (1, 2):
        drdb = params[f"drdb{n}"]
        for i in range(1, 6):
            _conv(drdb[f"dconv{i}"], f"{prefix}DRDB{n}.Dcov{i}.", out)
        _conv(drdb["bottleneck"], f"{prefix}DRDB{n}.conv.", out)
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


# the port's module names that the JAX package names otherwise (the maps
# above, read backwards), by the module's last name; a dotted pair maps
# its two names to one
_JAX_NAMES = {"denoise_net": "seg", "conv3": "seg_proj1",
              "conv4": "seg_proj2", "kv3": "kv_seg"}
_JAX_PAIRS = {("dwconv", "dwconv"): ["dwconv"],
              ("linear_fuse", "conv"): ["linear_fuse"],
              ("linear_fuse", "bn"): ["bn"], ("conv", "0"): ["conv_a"],
              ("conv", "2"): ["conv_b"]}


def jax_path(key: str) -> List[str]:
    """The JAX ``JointPipeline`` params path of the port's parameter
    ``key`` (a ``JointPipeline.state_dict()`` name): the converter's name
    map above read backwards. ``seg.denoise_net.encoder.block1.0.attn.kv.
    weight`` -> ``seg/seg/encoder/block1_0/attn/kv/kernel``; the decode
    head's ``linear_c1.proj.weight`` -> ``.../decoder/linear_c1/kernel``;
    the FFM's ``cross_attn.kv3.weight`` -> ``.../cross_attn/kv_seg/
    kernel``; norms' weights -> ``scale``; ``fusion.relu.weight`` ->
    ``fusion/prelu_alpha``."""
    *mods, leaf = key.split(".")
    if mods == ["fusion", "relu"]:
        return ["fusion", "prelu_alpha"]
    out: List[str] = []
    i = 0
    while i < len(mods):
        name = mods[i]
        pair = tuple(mods[i:i + 2])
        if pair in _JAX_PAIRS:
            out += _JAX_PAIRS[pair]
            i += 2
            continue
        if re.fullmatch(r"block\d", name) and i + 1 < len(mods):
            out.append(f"{name}_{mods[i + 1]}")
            i += 2
            continue
        if re.fullmatch(r"linear_c\d", name) and mods[i + 1:i + 2] == \
                ["proj"]:
            out.append(name)
            i += 2
            continue
        if name == "conv" and out and out[-1].startswith("drdb"):
            out.append("bottleneck")
        elif re.fullmatch(r"DRDB\d", name):
            out.append(name.lower())
        elif re.fullmatch(r"Dcov\d", name):
            out.append("dconv" + name[4:])
        else:
            out.append(_JAX_NAMES.get(name, name))
        i += 1
    if leaf == "weight":
        norm = "norm" in out[-1] or out[-1] == "bn"
        leaf = "scale" if norm else "kernel"
    return out + [leaf]
