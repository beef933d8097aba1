"""The row-sharded fusion trunk of the port (``segmif_tpu_torch.parallel.
spatial``) on gloo CPU ranks, f32, channels 64, at 70x32: 4 does not
divide 70, so the 4-rank blocks are of uneven height (18, 18, 17, 17).

 - ``spatial_fuse_batched`` with 1, 2 and 4 shards against the JAX
   package's single-device ``FusionNetwork`` forward (batch 2, the taps at
   the encoder's resolution, upsampled by the trunk), fusion weights at
   the reference modules' scale
   (``port_weights``): within 3e-5, the tolerance of the variants' test;
   ``spatial_fuse`` (one image) within 1e-6 of the batched form's image.
 - With full-resolution taps (batch 1) against JAX's own ``spatial_fuse``
   on a 2- and a 4-device CPU mesh (``tests/conftest.py``'s virtual
   devices): within 3e-5.
 - ``make_spatial_fuse_fn`` on 2 ranks against the port's ``make_fuse_fn``
   (mit_b0 guide taps from the guide encoder, one process): the fused Y
   and RGB within 3e-5.
 - 2 and 4 shards against one shard of the port within 2e-6: the row
   split changes nothing but the order of the grams' sums. Planted faults
   fail that check: a halo of 8 rows (the trunk reaches 11) and the FFM
   grams left unsummed over the ranks.
 - ``row_blocks``: the uneven split, and the refusal of blocks of fewer
   than 16 rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallel_ranks as pr
import train_parity as tp
from port_weights import torch_default_init
from segmif_tpu.models.fusion import FusionNetwork as JaxFusionNetwork
from segmif_tpu.parallel.mesh import make_mesh as jax_make_mesh
from segmif_tpu.parallel.spatial import spatial_fuse as jax_spatial_fuse
from segmif_tpu_torch.convert import fusion_state_dict_from_jax
from segmif_tpu_torch.parallel import dist
from segmif_tpu_torch.models.fusion import FusionNetwork
from segmif_tpu_torch.parallel.mesh import Mesh
from segmif_tpu_torch.parallel.spatial import row_blocks, spatial_fuse
from segmif_tpu_torch.train.steps import make_fuse_fn
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

H, W = 70, 32
ATOL = 3e-5
# N shards against one: the same maths but for the order in which the
# FFM grams are summed (2.5e-7 apart at 2 shards). A halo of 8 rows moves
# the fused Y by 1.0e-5 here, inside ATOL at these weights, so the faults
# are held to this limit
SHARD_ATOL = 2e-6
LAUNCH_S = 240


def _inputs(seed, b, full_taps):
    """ir, vis Y [b,H,W,1] and the taps: at the encoder's resolution
    (stage 1: ceil(H/4) x ceil(W/4), stage 2: half that), or at H x W."""
    rng = np.random.default_rng(seed)
    t1 = (H, W) if full_taps else (-(-H // 4), -(-W // 4))
    t2 = (H, W) if full_taps else (-(-t1[0] // 2), -(-t1[1] // 2))
    return {"ir": rng.uniform(0, 1, (b, H, W, 1)).astype(np.float32),
            "vis": rng.uniform(0, 1, (b, H, W, 1)).astype(np.float32),
            "tap1": rng.normal(0, 1, (b,) + t1 + (64,)).astype(np.float32),
            "tap2": rng.normal(0, 1, (b,) + t2 + (128,)).astype(np.float32)}


@pytest.fixture(scope="module")
def setup():
    """JAX FusionNetwork params at the reference scale (taps of 64 and
    128 channels), their state dict for the port's FusionNetwork, the
    inputs and JAX's forward."""
    native, full = _inputs(0, 2, False), _inputs(1, 1, True)
    jmodel = JaxFusionNetwork()
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), *(jnp.asarray(native[k]) for k in
                                 ("ir", "vis", "tap1", "tap2")))["params"])
    params = torch_default_init(params, np.random.default_rng(0))
    want = np.asarray(jax.jit(jmodel.apply)(
        {"params": params}, *(jnp.asarray(native[k]) for k in
                              ("ir", "vis", "tap1", "tap2"))))
    sd = {k: v.numpy() for k, v in fusion_state_dict_from_jax(
        params).items()}
    return dict(params=params, sd=sd, native=native, full=full, want=want)


def _case(setup, inputs, **kw):
    return dict(sd=setup["sd"], inputs=setup[inputs], **kw)


@pytest.fixture(scope="module")
def ranks2(setup, tmp_path_factory):
    """Two ranks: native taps, full taps, both faults; and the pipeline
    of a mit_b0 JointPipeline."""
    _, variables = tp.jax_variables()
    joint = pr.state_dict_numpy(tp.port_model(variables))
    rng = np.random.default_rng(2)
    pipe_in = {"ir": rng.uniform(0, 1, (2, H, W, 1)).astype(np.float32),
               "vis": rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32),
               "guide": rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32)}
    pipe = dict(sd=joint, backbone="mit_b0", classes=tp.CLASSES,
                inputs=pipe_in, pipeline=True)
    cases = [_case(setup, "native"), _case(setup, "full"),
             _case(setup, "native", halo=8),
             _case(setup, "native", faults=("grams_local",)), pipe]
    got = dist.launch(pr.spatial_cases, 2, (cases,), timeout=LAUNCH_S,
                      threads=1, workdir=str(tmp_path_factory.mktemp("r")))
    model = tp.port_model(variables)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # beside the other test workers
    try:
        pipe_want = [t.numpy() for t in make_fuse_fn(
            model, torch.float32, "cpu")(*(torch.from_numpy(pipe_in[k])
                                          for k in ("ir", "vis", "guide")))]
    finally:
        torch.set_num_threads(threads)
    return got, pipe_want


@pytest.fixture(scope="module")
def ranks4(setup, tmp_path_factory):
    cases = [_case(setup, "native"), _case(setup, "full")]
    return dist.launch(pr.spatial_cases, 4, (cases,), timeout=LAUNCH_S,
                       threads=1, workdir=str(tmp_path_factory.mktemp("r")))


def _jax_spatial(setup, n):
    f = setup["full"]
    return np.asarray(jax_spatial_fuse(
        jax_make_mesh(data=n, model=1), setup["params"],
        *(jnp.asarray(f[k][0]) for k in ("ir", "vis", "tap1", "tap2"))))


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_spatial_fuse_matches_jax_fusion_network(setup, ranks2, ranks4,
                                                 shards):
    if shards == 1:
        got = [pr.spatial_case(None, _case(setup, "native"))]
        # the single-image form, on the batch's second image
        x = {k: torch.from_numpy(v[1]) for k, v in setup["native"].items()}
        fusion = FusionNetwork()
        fusion.load_state_dict({k: torch.from_numpy(v)
                                for k, v in setup["sd"].items()})
        with torch.inference_mode():
            one = spatial_fuse(Mesh(1), fusion.eval(), x["ir"], x["vis"],
                               x["tap1"], x["tap2"])
        # (f32 convs on a batch of 1 and of 2 round apart)
        np.testing.assert_allclose(one.numpy(), got[0][1], rtol=0,
                                   atol=1e-6)
    else:
        got = [r[0] for r in (ranks2[0] if shards == 2 else ranks4)]
    for y in got:   # every rank holds the whole fused Y
        assert y.shape == (2, H, W, 1)
        np.testing.assert_allclose(y, setup["want"], rtol=0, atol=ATOL)


@pytest.mark.parametrize("shards", [2, 4])
def test_spatial_fuse_matches_jax_spatial_fuse(setup, ranks2, ranks4,
                                               shards):
    want = _jax_spatial(setup, shards)
    for r in (ranks2[0] if shards == 2 else ranks4):
        np.testing.assert_allclose(r[1][0], want, rtol=0, atol=ATOL)


def test_make_spatial_fuse_fn_matches_make_fuse_fn(ranks2):
    got, (want_rgb, want_y) = ranks2
    for r in got:
        rgb, y = r[4]
        np.testing.assert_allclose(y, want_y, rtol=0, atol=ATOL)
        np.testing.assert_allclose(rgb, want_rgb, rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def one_shard(setup):
    return pr.spatial_case(None, _case(setup, "native"))


@pytest.mark.parametrize("shards", [2, 4])
def test_spatial_fuse_matches_one_shard(ranks2, ranks4, one_shard, shards):
    for r in (ranks2[0] if shards == 2 else ranks4):
        np.testing.assert_allclose(r[0], one_shard, rtol=0, atol=SHARD_ATOL)


@pytest.mark.parametrize("fault", [2, 3], ids=["halo 8", "grams local"])
def test_planted_spatial_faults_fail(ranks2, one_shard, fault):
    err = np.abs(ranks2[0][0][fault] - one_shard).max()
    assert err > SHARD_ATOL, err


def test_row_blocks():
    assert row_blocks(70, 4) == [(0, 18), (18, 36), (36, 53), (53, 70)]
    assert row_blocks(1080, 7)[0] == (0, 155)
    assert row_blocks(1080, 7)[-1] == (926, 1080)
    assert row_blocks(64, 4) == [(0, 16), (16, 32), (32, 48), (48, 64)]
    with pytest.raises(ValueError, match="rows per shard 15 < halo 16"):
        row_blocks(63, 4)
