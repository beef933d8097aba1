"""The port's 1080p/mit_b5 stretch CLI (``segmif_tpu_torch.cli.stretch``)
against the JAX package's, on the CPU at small sizes (f32):

 - the CLI end to end (the counterpart of
   ``tests/test_spatial.py::test_stretch_cli_synthetic``, with one shard),
   ``--spatial N`` refused where a rank would hold fewer than 16 rows,
   ``--data_root`` on a folder written here (``--spatial 2`` on CPU
   ranks is in ``test_torch_spatial_cli.py``);
 - its fuse and seg on weights converted from a JAX ``JointPipeline``
   against the JAX stretch's own (``make_spatial_fuse_fn`` on a one-device
   mesh, and ``seg``) on the same ``default_rng(0)`` pair at mit_b0 64x64:
   fused RGB within 3e-5 and logits within 2e-4, the golden tolerances of
   ``tests/test_reference_parity.py:74,125``;
 - the mit_b4 / mit_b5 shapes are in ``test_torch_stretch_shapes.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_thread  # noqa: F401 (autouse fixture)
from port_weights import torch_default_init
from segmif_tpu.models.network import JointPipeline as JaxJointPipeline
from segmif_tpu.parallel.mesh import make_mesh
from segmif_tpu.parallel.spatial import make_spatial_fuse_fn
from segmif_tpu_torch.cli import stretch
from segmif_tpu_torch.convert import state_dict_from_jax
from segmif_tpu_torch.eval.image_io import save_png
from segmif_tpu_torch.models.network import JointPipeline

CONFIG = "configs/stretch_1080p.yaml"
SMALL = ["--config", CONFIG, "--backbone", "mit_b0", "--device", "cpu"]


def test_stretch_cli_synthetic(capsys):
    stretch.main(SMALL + ["--spatial", "1", "--synthetic", "--size", "64",
                          "64"])
    out = capsys.readouterr().out
    assert "stretch 1080p OK" in out
    assert "backbone=mit_b0" in out
    assert "fused shape (1, 64, 64, 3), logits shape (1, 16, 16, 15)" in out
    assert "[steady-state] fuse" in out


def test_stretch_cli_no_seg(capsys):
    fused, logits = stretch.main(SMALL + ["--synthetic", "--size", "32",
                                          "32", "--no_seg"])
    out = capsys.readouterr().out
    assert logits is None and "fused shape (1, 32, 32, 3)\n" in out
    assert ", seg" not in out and "stretch 1080p OK" in out


def test_stretch_spatial_refused():
    # 8 shards give 32 rows 4 a rank: refused before any rank is spawned
    with pytest.raises(ValueError, match="rows per shard 4 < halo 16"):
        stretch.main(SMALL + ["--spatial", "8", "--synthetic", "--size",
                              "32", "32"])


def test_stretch_data_root(tmp_path, capsys):
    rng = np.random.default_rng(3)
    root = tmp_path / "test_all"
    names = ["a.png", "b.png"]
    for n in names:
        for d, c in (("Infrared", 1), ("Visible", 3), ("Mask2", 3),
                     ("Label", 1)):
            a = rng.integers(0, 9 if d == "Label" else 256, (32, 48, c))
            save_png(root / d / n, a.astype(np.uint8)[..., 0] if c == 1
                     else a.astype(np.uint8))
    out_dir = tmp_path / "Fused"
    got_names, fused = stretch.main(SMALL + ["--data_root", str(root),
                                             "--out_dir", str(out_dir)])
    assert got_names == names and fused.shape == (2, 32, 48, 3)
    assert sorted(p.name for p in out_dir.iterdir()) == names
    assert f"fused 2 images at 1080x1920 -> {out_dir}" in \
        capsys.readouterr().out


@pytest.fixture(scope="module")
def jax_pipeline():
    """A JAX mit_b0 JointPipeline of the stretch config's 15 classes, its
    fusion weights at the reference modules' scale (``port_weights``), and
    the port's copy of it."""
    model = JaxJointPipeline("mit_b0", num_classes=15, dtype=jnp.float32)
    np_vars = jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)),
        jnp.zeros((1, 64, 64, 3))))
    np_vars["params"]["fusion"] = torch_default_init(
        np_vars["params"]["fusion"], np.random.default_rng(0))
    port = JointPipeline("mit_b0", num_classes=15)
    port.load_state_dict(state_dict_from_jax(np_vars["params"],
                                             np_vars["batch_stats"]))
    return model, jax.tree.map(jnp.asarray, np_vars), port


def test_stretch_fuse_and_seg_match_jax(jax_pipeline):
    model, variables, port = jax_pipeline
    ir, vis = stretch.synthetic_pair(64, 64)
    fuse_fn = jax.jit(make_spatial_fuse_fn(make_mesh(data=1), model))
    j_rgb, _ = fuse_fn(variables, jnp.asarray(ir.numpy()),
                       jnp.asarray(vis.numpy()), jnp.asarray(vis.numpy()))
    j_logits = model.apply(variables, j_rgb,
                           method=lambda m, im: m.seg(im, True))
    fuse, seg = stretch.make_stretch_fns(port, torch.float32, "cpu")
    rgb, _ = fuse(ir, vis, vis)
    logits = seg(rgb)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(j_rgb), atol=3e-5)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               atol=2e-4)
