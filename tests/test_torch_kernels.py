"""The port's kernel modules (plain versions, CPU) against the JAX package.

Same numpy-seeded inputs through both sides, f32. The Pallas kernels run
in interpret mode, as tests/test_kernels.py runs them on the CPU.
"""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmif_tpu.kernels import pallas_attention as pa
from segmif_tpu.kernels import pallas_ffm as pf
from segmif_tpu.kernels.pallas_drdb import drdb_xla
from segmif_tpu_torch.convert import _conv
from segmif_tpu_torch.kernels import ffm as tffm
from segmif_tpu_torch.kernels.attention import sr_attention
from segmif_tpu_torch.kernels.drdb import drdb_chain

C = 64


def _interpret(monkeypatch, mod):
    orig = mod.pl.pallas_call
    monkeypatch.setattr(mod.pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("n,m,h,d", [
    (512, 128, 2, 64),     # aligned
    (300, 300, 8, 64),     # stage-4-like: N and M both unaligned
    (1200, 300, 5, 64),    # stage-3-like
])
def test_sr_attention_matches_pallas(monkeypatch, n, m, h, d):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((1, n, h, d), (1, m, h, d), (1, m, h, d)))
    scale = d ** -0.5
    _interpret(monkeypatch, pa)
    expect = pa._sr_attention_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), scale)
    got = sr_attention(_t(q), _t(k), _t(v), scale)   # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=2e-5)


def _ffm_arrays(seed, b, n):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((b, n, C)).astype(np.float32)
          for _ in range(3)]
    wp = (rng.standard_normal((3, C, 2 * C)) * 0.1).astype(np.float32)
    bp = (rng.standard_normal((3, 2 * C)) * 0.1).astype(np.float32)
    return rng, xs, wp, bp


@pytest.mark.parametrize("n", [200, 256])  # 200: not a multiple of the tile
def test_grams_match_pallas(monkeypatch, n):
    _, (x1, x2, s), wp, bp = _ffm_arrays(1, 2, n)
    _interpret(monkeypatch, pf)
    monkeypatch.setattr(pf, "TILE_N", 64)
    expect = np.asarray(pf._grams_pallas(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(s), jnp.asarray(wp),
        jnp.asarray(bp[:, None, :])))
    got = tffm.crosspath_grams(_t(x1), _t(x2), _t(s), _t(wp), _t(bp)).numpy()
    # the port returns the three blocks the contexts read
    for i, blk in ((0, np.s_[:C, :C]), (1, np.s_[:C, :C]),
                   (2, np.s_[C:, C:])):
        np.testing.assert_allclose(got[:, i], expect[:, i][(slice(None),)
                                                           + blk],
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n", [200, 256])
def test_apply_rows_match_pallas(monkeypatch, n):
    rng, (x1, x2, s), wp, bp = _ffm_arrays(2, 2, n)
    mats = (rng.standard_normal((2, 4, C, C)) * 0.1).astype(np.float32)
    be = (rng.standard_normal((2, C)) * 0.1).astype(np.float32)
    lnp = np.stack([np.stack([1 + 0.1 * rng.standard_normal(C),
                              0.1 * rng.standard_normal(C)])
                    for _ in range(2)]).astype(np.float32)
    # the TPU kernel takes the contexts zero-padded to [2C, C]: M0 and M2
    # read the y3 half of r3, M1 and M3 the u half of r1 / r2
    padded = np.zeros((2, 4, 2 * C, C), np.float32)
    padded[:, 0, :C], padded[:, 1, C:] = mats[:, 0], mats[:, 1]
    padded[:, 2, :C], padded[:, 3, C:] = mats[:, 2], mats[:, 3]
    _interpret(monkeypatch, pf)
    monkeypatch.setattr(pf, "TILE_N", 64)
    e1, e2 = pf._apply_pallas(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(s), jnp.asarray(wp),
        jnp.asarray(bp[:, None, :]), jnp.asarray(padded), jnp.asarray(be),
        jnp.asarray(lnp))
    g1, g2 = tffm.crosspath_apply_rows(_t(x1), _t(x2), _t(s), _t(wp),
                                       _t(bp), _t(mats), _t(be), _t(lnp))
    np.testing.assert_allclose(g1.numpy(), np.asarray(e1), atol=3e-5)
    np.testing.assert_allclose(g2.numpy(), np.asarray(e2), atol=3e-5)


def _crosspath_weights(seed):
    rng = np.random.default_rng(seed)
    w = {}
    for i in (1, 2, 3):
        w[f"wp{i}"] = rng.standard_normal((C, 2 * C)) * 0.1
        w[f"bp{i}"] = rng.standard_normal(2 * C) * 0.1
        w[f"wkv{i}"] = rng.standard_normal((C, 2 * C)) * 0.05
    for i in (1, 2):
        w[f"we{i}"] = rng.standard_normal((2 * C, C)) * 0.1
        w[f"be{i}"] = rng.standard_normal(C) * 0.1
        w[f"ln{i}_scale"] = 1 + 0.1 * rng.standard_normal(C)
        w[f"ln{i}_bias"] = 0.1 * rng.standard_normal(C)
    w = {k: v.astype(np.float32) for k, v in w.items()}
    xs = [rng.uniform(0, 1, (2, 8, 12, C)).astype(np.float32)
          for _ in range(3)]
    return w, xs


def test_crosspath_folded_ref_matches_xla():
    """Plain folded CrossPath vs crosspath_folded_xla, in the NHWC layout
    (rank-polymorphic like the JAX function)."""
    w, (x1, x2, s) = _crosspath_weights(3)
    scale = (C // 8) ** -0.5
    e1, e2 = pf.crosspath_folded_xla(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(s),
        {k: jnp.asarray(v) for k, v in w.items()}, scale, 8)
    g1, g2 = tffm.crosspath_folded_ref(
        _t(x1), _t(x2), _t(s), {k: _t(v) for k, v in w.items()}, scale, 8)
    np.testing.assert_allclose(g1.numpy(), np.asarray(e1), atol=3e-5)
    np.testing.assert_allclose(g2.numpy(), np.asarray(e2), atol=3e-5)


def test_crosspath_fused_assembly_matches_xla():
    """grams -> contexts -> unpadded folded mats -> apply (the CUDA path's
    assembly, with the plain passes on CPU) vs crosspath_folded_xla."""
    w, xs = _crosspath_weights(4)
    x1, x2, s = (x.reshape(2, -1, C) for x in xs)
    scale = (C // 8) ** -0.5
    e1, e2 = pf.crosspath_folded_xla(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(s),
        {k: jnp.asarray(v) for k, v in w.items()}, scale, 8)
    g1, g2 = tffm.crosspath_fused(
        _t(x1), _t(x2), _t(s), {k: _t(v) for k, v in w.items()}, scale, 8)
    np.testing.assert_allclose(g1.numpy(), np.asarray(e1), atol=3e-5)
    np.testing.assert_allclose(g2.numpy(), np.asarray(e2), atol=3e-5)


def test_drdb_chain_matches_xla():
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (2, 16, 20, C)).astype(np.float32)
    w = {}
    cin = C
    for i in range(5):
        w[f"dconv{i + 1}"] = {
            "kernel": rng.standard_normal((3, 3, cin, 32)).astype(np.float32)
            * np.float32(np.sqrt(2 / (9 * 32))),
            "bias": (0.1 * rng.standard_normal(32)).astype(np.float32)}
        cin += 32
    w["bottleneck"] = {
        "kernel": rng.standard_normal((1, 1, cin, C)).astype(np.float32)
        * np.float32(np.sqrt(2 / C)),
        "bias": (0.1 * rng.standard_normal(C)).astype(np.float32)}
    expect = drdb_xla(jnp.asarray(x), {k: {kk: jnp.asarray(vv) for kk, vv
                                           in v.items()}
                                       for k, v in w.items()})

    def conv(p):
        sd = {}
        _conv(p, "", sd)
        return sd["weight"], sd["bias"]

    got = drdb_chain(_t(x).permute(0, 3, 1, 2),
                     [conv(w[f"dconv{i + 1}"]) for i in range(5)],
                     conv(w["bottleneck"]))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(expect), atol=3e-5)


def test_port_imports_no_jax():
    """Every module of segmif_tpu_torch imports in a fresh interpreter
    without pulling in jax, flax or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import segmif_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'segmif_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'segmif_tpu'))\n"
        "assert len(mods) >= 12, mods\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
