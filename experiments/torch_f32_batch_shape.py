#!/usr/bin/env python3
"""Whether the PyTorch port's f32 fusion step moves with its batch shape
because of the port or because of the model's conditioning. Run on a host
with one CUDA card, from the root of the repository:

    python3 experiments/torch_f32_batch_shape.py

``chip_smoke.py``'s phase 13 (a) control (``f32_control``: the fusion
step on the last data-parallel rank's rows, 97 % of their labels ignored,
alone against the same rows tiled to the whole batch of 8) with mit_b3 at
full depth: on the card at 480x640 in f32, then at 120x160 on the card in
f32 and on the CPU in f32 and f64 (at 480x640 the CPU's f64 step of 8
rows would need about 200 GB). If the CPU's f32 step moves as far as the
card's and its f64 step does not, the cause is f32 rounding amplified by
the model, not a kernel. Prints one line a control, then the card's name
and power limit.
"""
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

SMALL_HW = (120, 160)


def rows(hw, dtype):
    """``chip_smoke._dp_batches``'s fusion batch drawn at ``hw`` pixels
    (the same seed and draws), cut to the last rank's rows."""
    import torch

    gen = torch.Generator().manual_seed(cs.SEED + 130)
    b = cs.DP_FUSION[0]
    batch = cs.train_batch(gen, b, *hw, "cpu")
    share = torch.tensor([0.1] * (b // 2) + [0.97] * (b - b // 2))
    batch["label"][torch.rand((b, *hw), generator=gen)
                   < share[:, None, None]] = 255
    per = b // cs.DP_WORLD
    return {k: (v[-per:].to(dtype) if v.is_floating_point() else v[-per:])
            for k, v in batch.items()}


def control(models, dev, hw, dtype) -> str:
    import torch

    mine = rows(hw, dtype)

    def run(b):
        return cs.dp_steps(models, dev, dtype, kinds=("fusion",),
                           fusion_batch=b)["fusion"]

    got = run(mine)
    want = run({k: torch.cat([v] * cs.DP_WORLD) for k, v in mine.items()})
    return (f"control, {str(dtype)[6:]} fusion step on "
            f"{torch.device(dev).type} at {hw[0]}x{hw[1]}, the last rank's "
            f"{cs.DP_FUSION[0] // cs.DP_WORLD} rows against the same rows "
            f"tiled to batch {cs.DP_FUSION[0]}: "
            + cs.f32_line(cs.f32_errors(got, want, "fusion"), "fusion"))


def main() -> int:
    import torch

    from segmif_tpu_torch import drift
    from segmif_tpu_torch.models.network import (JointPipeline,
                                                 SegmentationNetwork,
                                                 init_params)

    if not torch.cuda.is_available():
        print("no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    models = (drift.init_reference_scale(
        JointPipeline("mit_b3"), torch.Generator().manual_seed(cs.SEED + 131)),
        init_params(SegmentationNetwork("mit_b3"),
                    torch.Generator().manual_seed(cs.SEED + 132)))
    for where, hw, dtype in ((dev, cs.DP_FUSION[1:], torch.float32),
                             (dev, SMALL_HW, torch.float32),
                             ("cpu", SMALL_HW, torch.float32),
                             ("cpu", SMALL_HW, torch.float64)):
        t0 = time.perf_counter()
        line = control(models, where, hw, dtype)
        print(f"{line} (mit_b3 full depth; {time.perf_counter() - t0:.1f} "
              f"s)", flush=True)
    print(subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
