"""The port's serving closure against ``segmif_tpu.serving`` on the CPU (f32).

Default mode (guide = VIS, re-encoded per pair) and static-guide mode
(taps computed once). fused_rgb within 1e-4 (as tests/test_serving.py
holds the JAX closure to model.apply); the class map may flip at
near-ties of the upsampled logits, so pred agrees on >= 99.9% of pixels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmif_tpu import serving as jax_serving
from port_weights import torch_default_init
from segmif_tpu.models.network import JointPipeline as JaxJointPipeline
from segmif_tpu_torch import serving
from segmif_tpu_torch.convert import state_dict_from_jax
from segmif_tpu_torch.models.network import JointPipeline

B, H, W = 2, 32, 32


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(1)
    ir = rng.uniform(0, 1, (B, H, W, 1)).astype(np.float32)
    vis = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    guide = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    jmodel = JaxJointPipeline("mit_b0", num_classes=9)
    np_vars = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(1), jnp.asarray(ir), jnp.asarray(vis)))
    # fusion weights at the reference modules' scale (see port_weights)
    np_vars["params"]["fusion"] = torch_default_init(
        np_vars["params"]["fusion"], rng)
    variables = jax.tree.map(jnp.asarray, np_vars)
    port = JointPipeline("mit_b0", num_classes=9)
    port.load_state_dict(state_dict_from_jax(np_vars["params"],
                                             np_vars["batch_stats"]))
    return jmodel, variables, port, ir, vis, guide


@pytest.mark.parametrize("mode", ["default", "static_guide"])
def test_serving_fn_matches_jax(setup, mode):
    jmodel, variables, port, ir, vis, guide = setup
    g = guide if mode == "static_guide" else None
    jserve = jax_serving.make_serving_fn(
        jmodel, variables, guide_rgb=None if g is None else jnp.asarray(g))
    rgb_e, pred_e = (np.asarray(t) for t in jserve(jnp.asarray(ir),
                                                   jnp.asarray(vis)))
    serve = serving.make_serving_fn(
        port, guide_rgb=None if g is None else torch.from_numpy(g),
        device="cpu")
    rgb, pred = serve(torch.from_numpy(ir), torch.from_numpy(vis))
    assert pred.dtype == torch.int32 and pred.shape == (B, H, W)
    np.testing.assert_allclose(rgb.numpy(), rgb_e, atol=1e-4)
    assert (pred.numpy() == pred_e).mean() >= 0.999


def test_static_guide_taps_are_used(setup):
    """With a static guide the output differs from the VIS-guided one, and
    equals fuse() given the precomputed taps."""
    _, _, port, ir, vis, guide = setup
    ir_t, vis_t = torch.from_numpy(ir), torch.from_numpy(vis)
    taps = serving.precompute_guide_taps(port, torch.from_numpy(guide),
                                         device="cpu")
    assert taps[0].shape == (B, H // 4, W // 4, 32)
    assert taps[1].shape == (B, H // 8, W // 8, 64)
    rgb_guided = serving.make_serving_fn(
        port, guide_rgb=torch.from_numpy(guide), with_seg=False,
        device="cpu")(ir_t, vis_t)
    with torch.inference_mode():
        rgb_taps, _ = port.fuse(ir_t, vis_t, taps=taps)
        rgb_vis, _ = port.fuse(ir_t, vis_t)
    torch.testing.assert_close(rgb_guided, rgb_taps, rtol=0, atol=0)
    assert not torch.allclose(rgb_guided, rgb_vis)


@pytest.mark.parametrize("name,cls", [
    ("void segmif::(anonymous namespace)::growth_conv_kernel<__nv_bfloat16>",
     "DRDB growth kernel"),
    ("void segmif::(anonymous namespace)::tail_kernel<__nv_bfloat16>",
     "DRDB tail kernel"),
    ("void segmif::(anonymous namespace)::ffm_apply_kernel<__nv_bfloat16>",
     "FFM kernels"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "cuDNN convs"),
    ("void at::native::elementwise_kernel<128, 4, at::native::"
     "gpu_kernel_impl_nocast<at::native::CUDAFunctor_add<c10::BFloat16>>>",
     "elementwise"),
    ("nvjet_tst_64x384_64x3_1x2_h_bz_coopB_bias_TNT", "other"),
    ("void segmif::(anonymous namespace)::int8_tail_kernel<__nv_bfloat16>",
     "DRDB int8 kernels"),
    ("segmif::(anonymous namespace)::int8_conv_kernel(signed char*, ...)",
     "DRDB int8 kernels"),
])
def test_profile_kernel_classes(name, cls):
    """The profiler's kernel names fall into the classes of the report."""
    from segmif_tpu_torch.profile_serving import kernel_class
    assert kernel_class(name) == cls


def test_profile_busy_time_is_the_union_of_spans():
    from segmif_tpu_torch.profile_serving import busy_us
    assert busy_us([]) == 0.0
    assert busy_us([(5, 9), (0, 2), (1, 3), (8, 10)]) == 8.0
    assert busy_us([(0, 10), (2, 3)]) == 10.0
