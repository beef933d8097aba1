"""Shared set-up of the port's export tests (``test_torch_export*.py``):
a seeded mit_b0 ``JointPipeline`` and one 32x32 pair and guide, the
serving modes, and the round trip of one mode through a ``.pt2`` file
against ``make_serving_fn(device="cpu")``.

On the CPU the program's graph calls the ``segmif::`` operators as often
as the CPU serving path does: sr-attention 4 per encoder pass over stages
1-2 (the guide taps) and 8 per full mit_b0 pass, the DRDB growth and tail
(or their int8 forms) 4 each. The 'both' CrossPath runs its plain folded
form on the CPU (``kernels.ffm.crosspath_apply``), so no FFM operator
appears (on the card, ``chip_smoke.py`` phase 12 (d) counts 2 + 2).
"""
import numpy as np
import torch

from segmif_tpu_torch import serving
from segmif_tpu_torch.models.network import JointPipeline, init_params

B, H, W = 1, 32, 32
FLOAT = {"drdb_growth": 4, "drdb_tail": 4}
INT8 = {"drdb_int8_growth": 4, "drdb_int8_tail": 4}
# mode -> (serving options, segmif:: nodes of the program)
MODES = {"default": ({}, {"sr_attention": 12, **FLOAT}),
         "static_guide": ({"guide": True}, {"sr_attention": 8, **FLOAT}),
         "int8": ({"int8": True}, {"sr_attention": 12, **INT8}),
         "fuse_only": ({"with_seg": False}, {"sr_attention": 4, **FLOAT})}


def setup():
    rng = np.random.default_rng(7)
    ir, vis, guide = (torch.from_numpy(rng.uniform(0, 1, (B, H, W, c))
                                       .astype(np.float32))
                      for c in (1, 3, 3))
    model = init_params(JointPipeline("mit_b0"),
                        torch.Generator().manual_seed(7)).eval()
    return model, ir, vis, guide


def serving_kwargs(mode, ir, vis, guide):
    spec = MODES[mode][0]
    kw = {"with_seg": spec.get("with_seg", True)}
    if spec.get("guide"):
        kw["guide_rgb"] = guide
    if spec.get("int8"):
        kw["int8_calibration"] = (ir, vis)
    return kw


def assert_roundtrip(setup, path, mode):
    """Export ``mode``, save it to ``path``, load it: its graph's
    ``segmif::`` nodes are the mode's, and its outputs equal
    ``make_serving_fn``'s bit for bit (one process, the same CPU kernels in
    the same order)."""
    model, ir, vis, guide = setup
    kw = serving_kwargs(mode, ir, vis, guide)
    data = serving.export_serving_artifact(model, B, H, W, device="cpu",
                                           **kw)
    serving.save_serving_artifact(path, data)
    assert path.stat().st_size == len(data)
    loaded = serving.load_serving_artifact(path)
    assert serving.segmif_nodes(loaded) == MODES[mode][1]
    got = loaded(ir, vis)
    want = serving.make_serving_fn(model, device="cpu", **kw)(ir, vis)
    if not kw["with_seg"]:
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if kw["with_seg"]:
        assert got[1].dtype == torch.int32 and got[1].shape == (B, H, W)
