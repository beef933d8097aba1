"""A ``.pt2`` serving program loaded and run by a fresh process that
imports only torch and ``segmif_tpu_torch.kernels`` (which registers the
``segmif::`` operators): no model code of the port is imported there, and
the outputs equal the exporting process's ``make_serving_fn`` bit for bit
(both on one CPU thread). mit_b0 at 32x32 on the CPU.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from torch_threads import one_thread  # noqa: F401 (autouse fixture)
from segmif_tpu_torch import serving
from segmif_tpu_torch.cli.test_fusion import build_model

ROOT = Path(__file__).resolve().parents[1]


LOADER = """
import json, sys
import numpy as np
import torch
import segmif_tpu_torch.kernels
torch.set_num_threads(1)
fn = torch.export.load(sys.argv[1]).module()
io = np.load(sys.argv[2])
with torch.inference_mode():
    rgb, pred = fn(torch.from_numpy(io["ir"]), torch.from_numpy(io["vis"]))
np.savez(sys.argv[3], rgb=rgb.numpy(), pred=pred.numpy())
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("segmif_tpu_torch", "jax",
                                               "segmif_tpu"))))
"""


def test_artifact_loads_in_a_fresh_process(tmp_path):
    model = build_model("mit_b0", 9)
    path = tmp_path / "serve.pt2"
    serving.save_serving_artifact(path, serving.export_serving_artifact(
        model, 1, 32, 32, device="cpu"))
    rng = np.random.default_rng(12)
    ir = rng.uniform(0, 1, (1, 32, 32, 1)).astype(np.float32)
    vis = rng.uniform(0, 1, (1, 32, 32, 3)).astype(np.float32)
    np.savez(tmp_path / "in.npz", ir=ir, vis=vis)
    proc = subprocess.run(
        [sys.executable, "-c", LOADER, str(path), str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz")], capture_output=True, text=True,
        timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    mods = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "segmif_tpu_torch.kernels" in mods
    assert not [m for m in mods if m.split(".")[0] != "segmif_tpu_torch"
                or m.startswith(("segmif_tpu_torch.models",
                                 "segmif_tpu_torch.serving"))], mods
    got = np.load(tmp_path / "out.npz")
    rgb, pred = serving.make_serving_fn(model, device="cpu")(
        torch.from_numpy(ir), torch.from_numpy(vis))
    np.testing.assert_array_equal(got["rgb"], rgb.numpy())
    np.testing.assert_array_equal(got["pred"], pred.numpy())
