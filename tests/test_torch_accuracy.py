"""``python -m segmif_tpu_torch.accuracy`` against the JAX package's
``accuracy.py`` on the CPU.

 - A cut overfit in f64 on both sides: two rounds of the interactive
   trainers through ``test_torch_interactive_parity.run_round`` (mit_b0,
   4 training and 2 validation samples at 32x32, 2 fusion and 2 seg
   iterations a round, the same initial weights and augmentation draws,
   SGD on both sides). The port's fields (``accuracy.overfit_fields`` of
   the port trainer) must equal those that ``accuracy.py``'s own formulas
   give from the JAX trainer's histories: ``accuracy.run_overfit`` is run
   with its trainer and dataset classes replaced, for this test, by the
   JAX trainer that already ran and by the same samples, and with its
   rounding lifted, so the unrounded values are compared (losses within
   rtol 1e-6, as the run's leaves; the mIoUs and the class prior
   exactly; the SSIM within 1e-6).
 - The CLI on ``--device cpu`` at a cut config (the overfit at mit_b0,
   32x32, 2 + 1 fusion and 2 seg iterations a round; the drift at mit_b0,
   1x32x32, with int8): its last line parses as JSON and holds every key
   of ``ACCURACY_r05.json`` (nested), and ``--out`` holds the same line.
"""
import json
from pathlib import Path

import numpy as np

import accuracy as jax_accuracy
import segmif_tpu.data.datasets as jax_datasets
import segmif_tpu.train.interactive as jax_interactive
from segmif_tpu.data.datasets import SyntheticFusionDataset as JaxSynthetic
from segmif_tpu_torch import accuracy
from segmif_tpu_torch.config import (DataConfig, FusionPhaseConfig,
                                     SegPhaseConfig, TrainConfig)
from segmif_tpu_torch.data.datasets import SyntheticFusionDataset
from test_torch_interactive_parity import run_round
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parent.parent


def _jax_fields(monkeypatch, ref, train):
    """``accuracy.py``'s ``run_overfit`` on the JAX trainer ``ref`` that
    already ran on the samples ``train``, unrounded."""
    class Ran:
        def __init__(self, *args, **kwargs):
            self.__dict__.update(vars(ref))

        def run(self):
            return {"best_mIoU": ref.best_miou, "history": ref.history}

    monkeypatch.setattr(jax_interactive, "InteractiveTrainer", Ran)
    monkeypatch.setattr(jax_datasets, "SyntheticFusionDataset",
                        lambda n, size: train)
    monkeypatch.setattr(jax_accuracy, "round", lambda x, n=None: x,
                        raising=False)
    return jax_accuracy.run_overfit()


def test_overfit_fields_match_jax_formulas_f64(tmp_path, monkeypatch):
    data = (JaxSynthetic(n=4, size=(32, 32)),
            JaxSynthetic(n=2, size=(32, 32), seed=1))
    port_data = (SyntheticFusionDataset(n=4, size=(32, 32)),
                 SyntheticFusionDataset(n=2, size=(32, 32), seed=1))
    ref, mine = run_round(tmp_path, monkeypatch, data, port_data, rounds=2)
    got = accuracy.overfit_fields(mine, port_data[0])
    want = _jax_fields(monkeypatch, ref, data[0])
    assert set(got) == set(want) == set(accuracy.OVERFIT_FIELDS)
    for k in ("mIoU_round1", "mIoU_round2", "best_mIoU",
              "class_prior_mIoU"):
        assert got[k] == want[k], k
    for k in ("fusion_r1_head", "fusion_r1_min", "fusion_r1_tail",
              "fusion_r1_min_ratio", "ssim_vs_guide_round2"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert got["mIoU_round2"] > 0.0 and got["ssim_vs_guide_round2"] != 0.0


def _cut_config(seed, checkpoint_dir):
    return TrainConfig(
        backbone="mit_b0", rounds=2, log_iters=1, seed=seed,
        checkpoint_dir=checkpoint_dir, compute_dtype="float32",
        data=DataConfig(num_classes=9, crop_size=32,
                        rescale_range=(1.0, 1.0)),
        fusion=FusionPhaseConfig(iters_round1=2, iters_later=1,
                                 batch_size=4, crop_size=32,
                                 checkpoint_every=10_000),
        seg=SegPhaseConfig(iters=2, batch_size=4, eval_every=2),
        mesh_data=1)


def _has_keys(got, want, path="") -> None:
    assert isinstance(got, dict), path
    for k, v in want.items():
        assert k in got, f"{path}/{k}"
        if isinstance(v, dict):
            _has_keys(got[k], v, f"{path}/{k}")


def test_cli_line_has_the_jax_artifact_keys(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(accuracy, "overfit_config", _cut_config)
    monkeypatch.setattr(accuracy, "OVERFIT_SIZE", 32)
    monkeypatch.setattr(accuracy, "DRIFT_BACKBONE", "mit_b0")
    monkeypatch.setattr(accuracy, "DRIFT_SHAPE", (1, 32, 32))
    out = tmp_path / "acc.json"
    accuracy.main(["--device", "cpu", "--seeds", "1", "2", "--drift_int8",
                   "--out", str(out)])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    got = json.loads(last)
    assert out.read_text().strip() == last
    want = json.loads((ROOT / "ACCURACY_r05.json").read_text())
    _has_keys(got, want)
    assert got["platform"] == got["drift_platform"] == "cpu"
    assert got["overfit_seed_spread"]["seeds"] == [1, 2]
    assert got["overfit"] == got["overfit_per_seed"]["1"]
    for field, spread in got["overfit_seed_spread"].items():
        if field != "seeds":
            vals = spread["values"]
            assert spread["min"] == min(vals) and spread["max"] == max(vals)
    for pair in ("bf16_vs_f32", "int8_vs_f32", "int8_vs_bf16"):
        assert isinstance(got["drift"][pair]["within_limits"], bool)
