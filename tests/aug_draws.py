"""The JAX package's augmentation draws, for the port's ``augment.apply``.

``jax_draws(key, batch, cfg)`` repeats the ``jax.random.split``s of
``segmif_tpu/data/augment.py`` (``augment_batch`` splits the key per
sample; ``augment_sample`` splits it for the scale, the flip, the crop
candidates and the photometric distortion, which splits its key nine
ways) and returns the numbers they draw in the layout of the port's
``augment.draw``. Under ``train_parity.jax_in_f64`` the JAX package draws
f64 uniforms, and so does this.
"""
import jax
import numpy as np
import torch

from segmif_tpu_torch.data.augment import COINS


def _sample(k, cfg):
    k_scale, k_flip, k_crop, k_photo = jax.random.split(k, 4)
    k1, k2 = jax.random.split(k_crop)
    pk = jax.random.split(k_photo, 9)
    coin = {"brightness": pk[0], "contrast": pk[2], "saturation": pk[4],
            "hue": pk[6], "contrast_first": pk[8]}

    def uniform(key, lo, hi):
        return jax.random.uniform(key, (), minval=lo, maxval=hi)

    return {
        "scale": uniform(k_scale, cfg.scale_min, cfg.scale_max),
        "flip": jax.random.bernoulli(k_flip, cfg.flip_prob),
        "crop_u": np.stack([jax.random.uniform(k1, (cfg.crop_tries,)),
                            jax.random.uniform(k2, (cfg.crop_tries,))], -1),
        "coins": np.array([bool(jax.random.bernoulli(coin[c]))
                           for c in COINS]),
        "beta": uniform(pk[1], -cfg.brightness_delta, cfg.brightness_delta),
        "alpha": uniform(pk[3], *cfg.contrast_range),
        "sat": uniform(pk[5], *cfg.saturation_range),
        "hue": uniform(pk[7], -cfg.hue_delta, cfg.hue_delta),
    }


def jax_draws(key, batch: int, cfg):
    """The draws of ``augment_batch(key, ...)`` on ``batch`` samples, as
    the port's ``draw`` returns them (CPU tensors)."""
    per = [_sample(k, cfg) for k in jax.random.split(key, batch)]
    return {f: torch.from_numpy(np.stack([np.asarray(p[f]) for p in per]))
            for f in per[0]}
