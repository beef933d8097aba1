"""The port's serving export (``serving.export_serving_artifact`` and its
save / load / input specs) on the CPU, mit_b0 at 32x32, batch 1: the
counterparts of ``tests/test_serving.py``'s round trip and input specs,
in default and static-guide mode (``export_cases``: the loaded program
against ``make_serving_fn(device="cpu")`` bit for bit, and its
``segmif::`` nodes); int8 and fuse-only are in
``test_torch_export_int8.py``.
"""
import pytest

import export_cases
from torch_threads import one_thread  # noqa: F401 (autouse fixture)
from segmif_tpu_torch import serving


@pytest.fixture(scope="module")
def setup():
    return export_cases.setup()


@pytest.mark.parametrize("mode", ["default", "static_guide"])
def test_export_roundtrip(setup, tmp_path, mode):
    export_cases.assert_roundtrip(setup, tmp_path / f"{mode}.pt2", mode)


def test_serving_input_specs(setup, tmp_path):
    """Read from the program's input placeholders, without running it."""
    model = setup[0]
    path = tmp_path / "fuse.pt2"
    serving.save_serving_artifact(path, serving.export_serving_artifact(
        model, 2, 32, 48, with_seg=False, device="cpu"))
    assert serving.serving_input_specs(path) == (
        ((2, 32, 48, 1), "float32"), ((2, 32, 48, 3), "float32"))
