"""The port's serving export on the CPU in int8 and fuse-only mode
(``export_cases``): the counterpart of
``tests/test_serving.py::test_export_roundtrip_int8`` (the calibrated int8
DRDBs' weights travel inside the program, and its outputs equal the
in-process int8 serving's bit for bit), fuse-only, and the exporter
leaving the caller's model as it was.
"""
import pytest
import torch

import export_cases
from torch_threads import one_thread  # noqa: F401 (autouse fixture)
from segmif_tpu_torch import serving


@pytest.fixture(scope="module")
def setup():
    return export_cases.setup()


@pytest.mark.parametrize("mode", ["int8", "fuse_only"])
def test_export_roundtrip(setup, tmp_path, mode):
    export_cases.assert_roundtrip(setup, tmp_path / f"{mode}.pt2", mode)


def test_export_leaves_the_model_as_it_was(setup):
    """The exporter serves a copy: the caller's weights and quant modes
    are unchanged, and no packed weights are pinned on them."""
    model, ir, vis, _ = setup
    before = {k: v.clone() for k, v in model.state_dict().items()}
    serving.export_serving_artifact(model, 1, 32, 32, device="cpu",
                                    int8_calibration=(ir, vis))
    after = model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert all(d.quant == "none" for d in model.fusion.drdbs())
    assert all(getattr(d, "pinned_growth_w", None) is None
               for d in model.fusion.drdbs())
