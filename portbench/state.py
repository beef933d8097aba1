"""What the benchmark makes from ``--seed``: the weights (a state dict under
the reference checkpoints' names, made on the device in a few large calls)
and the inputs (pools of distinct batches, made on the device). The same
seed gives the same tensors; the program and the reference are handed the
same ones."""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from .reference.model import param_spec

# stream tags of the seed
WEIGHTS, SERVE_INPUTS, TRAIN_INPUTS, SAMPLE = range(1, 5)


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit generator seed from the run's seed and stream tags
    (numpy's ``SeedSequence``: any whole seed, streams independent)."""
    words = [int(seed) % (1 << 64), *tags]
    a, b = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(a) << 31) ^ int(b)


def generator(seed: int, tag: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, tag))
    return g


def _scale(init: str) -> float:
    kind, value = init.split(":")
    return 1.0 / math.sqrt(int(value)) if kind == "uniform" else float(value)


def make_state(cfg: Dict, seed: int, device, dtype=torch.float32
               ) -> Dict[str, torch.Tensor]:
    """The configuration's weights from ``seed``, on ``device`` in
    ``dtype`` (the type they are served or trained in), by
    ``reference.model.param_spec``'s initialisers: the uniform and the
    truncated normal leaves out of one uniform draw, the normal leaves out
    of one normal draw, each scaled by one multiply; norms at 1 and 0;
    PReLU 0.25. Integer counters stay int64."""
    spec = param_spec(cfg)
    out: Dict[str, torch.Tensor] = {}
    g = generator(seed, WEIGHTS, device)
    for kinds, draw in ((("uniform", "trunc_normal"), torch.rand),
                        (("normal",), torch.randn)):
        leaves = [(n, s, i) for n, s, i in spec if i.split(":")[0] in kinds]
        sizes = [int(np.prod(s)) for _, s, _ in leaves]
        if not leaves:
            continue
        flat = draw(sum(sizes), generator=g, device=device)
        per = lambda vals: torch.repeat_interleave(  # noqa: E731
            torch.tensor(vals, device=device), torch.tensor(sizes,
                                                            device=device))
        scale = per([_scale(i) for _, _, i in leaves])
        if "uniform" in kinds:
            trunc = per([i.startswith("trunc") for _, _, i in leaves]) > 0
            # U(-1, 1) for the uniform leaves; the truncated normal's
            # inverse CDF, within 2 std, for the others
            lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
            z = torch.erfinv(2.0 * (lo + flat * (1.0 - 2.0 * lo)) - 1.0)
            flat = torch.where(trunc, z * math.sqrt(2.0), flat * 2 - 1)
        flat = (flat * scale).to(dtype)
        for (n, s, _), t in zip(leaves, flat.split(sizes)):
            out[n] = t.view(s)
    for n, s, init in spec:
        if init == "ones":
            out[n] = torch.ones(s, device=device, dtype=dtype)
        elif init == "zeros":
            out[n] = torch.zeros(s, device=device, dtype=dtype)
        elif init == "prelu":
            out[n] = torch.full(s, 0.25, device=device, dtype=dtype)
        elif init == "count":
            out[n] = torch.zeros(s, device=device, dtype=torch.int64)
    return {n: out[n] for n, _, _ in spec}


def serve_pool(seed: int, pool: int, batch: int, h: int, w: int, device
               ) -> List[Dict[str, torch.Tensor]]:
    """``pool`` distinct batches of IR [B, H, W, 1] and VIS [B, H, W, 3]
    frames, uniform in [0, 1), float32."""
    g = generator(seed, SERVE_INPUTS, device)
    ir = torch.rand((pool, batch, h, w, 1), generator=g, device=device)
    vis = torch.rand((pool, batch, h, w, 3), generator=g, device=device)
    return [{"ir": ir[i], "vis": vis[i]} for i in range(pool)]


def train_pool(seed: int, pool: int, batch: int, h: int, w: int,
               classes: int, ignore_share: float, ignore_index: int,
               ramp_rows: int, device) -> List[Dict[str, torch.Tensor]]:
    """``pool`` distinct batches of the fusion phase. IR and VIS frames
    of an exposure and a contrast of their own, row by row and modality by
    modality (an offset in [0, 0.5) plus a gain in [0.2, 0.5) times
    uniform noise); the guide (the fusion target) brightening from row to
    row over each run of ``ramp_rows`` rows, from a gain of 0.1 to 1 on
    uniform noise, as sequences of frames from dusk to day: no two rows of
    a sequence weigh alike in a batch's means, and its halves least of
    all. Labels uniform over the classes with ``ignore_share`` of the
    pixels set to ``ignore_index``."""
    g = generator(seed, TRAIN_INPUTS, device)

    def frames(c):
        shape = (pool, batch, 1, 1, 1)
        offset = 0.5 * torch.rand(shape, generator=g, device=device)
        gain = 0.2 + 0.3 * torch.rand(shape, generator=g, device=device)
        return offset + gain * torch.rand((pool, batch, h, w, c),
                                          generator=g, device=device)

    ir, vis = frames(1), frames(3)
    step = torch.arange(batch, device=device) % ramp_rows
    ramp = 0.1 + 0.9 * step / max(ramp_rows - 1, 1)
    guide = ramp.view(1, batch, 1, 1, 1) * torch.rand(
        (pool, batch, h, w, 3), generator=g, device=device)
    label = torch.randint(0, classes, (pool, batch, h, w), generator=g,
                          device=device)
    drop = torch.rand((pool, batch, h, w), generator=g,
                      device=device) < ignore_share
    label = torch.where(drop, torch.full_like(label, ignore_index), label)
    return [{"ir": ir[i], "vis": vis[i], "guide": guide[i],
             "label": label[i]} for i in range(pool)]
