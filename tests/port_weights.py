"""Weights for the port-vs-JAX tests at the reference modules' scale."""
import numpy as np


def torch_default_init(tree, rng):
    """Re-draw every kernel and its bias as torch's default layer init
    does, U(-1/sqrt(fan_in), 1/sqrt(fan_in)): the weight scale of the
    reference modules the golden tests round-trip. The JAX package's own
    initialisers (variance scaling on fan_out) grow the fusion net's
    activations several-fold, and with them the f32 rounding noise that
    the fixed tolerances compare."""
    out = {}
    for k, v in tree.items():
        out[k] = torch_default_init(v, rng) if isinstance(v, dict) else v
    if "kernel" in tree:
        bound = 1.0 / np.sqrt(np.prod(tree["kernel"].shape[:-1]))
        for k in ("kernel", "bias"):
            if k in tree:
                out[k] = rng.uniform(-bound, bound, tree[k].shape
                                     ).astype(np.float32)
    return out
