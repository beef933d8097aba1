"""The port's int8 DRDB and calibrated int8 serving (CPU) against the JAX
package.

Same numpy-seeded inputs through both sides, f32. The TPU kernel
``drdb_strips_int8_pallas`` runs in interpret mode on phase strips, as
tests/test_int8.py runs it. Tolerances:
 - quantisers: int8 values equal, f32 scales equal (the same f32 ops);
 - the plain int8 DRDB against the TPU kernel: 1e-6 absolute, a few f32
   steps of outputs of order 1 (XLA's CPU fusion of the epilogue rounds
   once where the port rounds twice; 2.4e-7 measured). That allows no
   requant flip: one flipped r_i moves an output by about s_r |w|, 1e-3;
 - against ``drdb_chain_int8(dil=2)``, whose partial sums are bf16: below
   0.05, the JAX package's own bound between the two (test_int8.py:181);
 - the calibrated amaxes: rtol 1e-6 per block, 1e-5 through the pipeline
   (abs-maxes of activations that f32 sums in another order reach).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from port_weights import torch_default_init
from segmif_tpu import serving as jax_serving
from segmif_tpu.kernels import int8 as jint8
from segmif_tpu.kernels.pallas_drdb import (_phase_strips, drdb_apply,
                                            merge_strips, phase_split)
from segmif_tpu.kernels.pallas_drdb_int8 import drdb_strips_int8_pallas
from segmif_tpu.models.network import JointPipeline as JaxJointPipeline
from segmif_tpu_torch import serving
from segmif_tpu_torch.convert import (_conv, load_quant_from_jax,
                                      state_dict_from_jax)
from segmif_tpu_torch.kernels import int8 as tint8
from segmif_tpu_torch.kernels.drdb import drdb_block
from segmif_tpu_torch.models.fusion import DRDB
from segmif_tpu_torch.models.network import JointPipeline


def _params(rng, c, g):
    """JAX-layout DRDB params (HWIO) at torch's default conv scale."""
    w, cin = {}, c
    for i in range(5):
        b = 1 / np.sqrt(9 * cin)
        w[f"dconv{i + 1}"] = {
            "kernel": rng.uniform(-b, b, (3, 3, cin, g)).astype(np.float32),
            "bias": rng.uniform(-b, b, g).astype(np.float32)}
        cin += g
    b = 1 / np.sqrt(cin)
    w["bottleneck"] = {
        "kernel": rng.uniform(-b, b, (1, 1, cin, c)).astype(np.float32),
        "bias": rng.uniform(-b, b, c).astype(np.float32)}
    return w


def _jax(w):
    return jax.tree.map(jnp.asarray, w)


def _port(w):
    """(five (OIHW weight, bias)), (bottleneck weight, bias)."""
    def conv(p):
        sd = {}
        _conv(p, "", sd)
        return sd["weight"], sd["bias"]

    return ([conv(w[f"dconv{i + 1}"]) for i in range(5)],
            conv(w["bottleneck"]))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _case(seed, c, g, shape):
    """x [B, H, W, c] in [0, 1), params, and the JAX calibration amax."""
    rng = np.random.default_rng(seed)
    w = _params(rng, c, g)
    x = rng.uniform(0, 1, shape + (c,)).astype(np.float32)
    record = []
    drdb_apply(jnp.asarray(x), _jax(w), "grouped", record=record)
    return x, w, np.asarray(jint8.record_amax(record[0]))


def _quantized(w, amax):
    dconvs, bottleneck = _port(w)
    return tint8.quantize_drdb(dconvs, bottleneck, torch.tensor(amax))


def test_quantizers_match_jax():
    rng = np.random.default_rng(0)
    k = rng.normal(size=(3, 3, 96, 128)).astype(np.float32) * 0.1
    kq_e, sw_e = jint8.quantize_kernel(jnp.asarray(k))
    kq, sw = tint8.quantize_kernel(torch.from_numpy(k.transpose(3, 2, 0, 1)))
    assert kq.dtype == torch.int8
    np.testing.assert_array_equal(kq.numpy(),
                                  np.asarray(kq_e).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(sw_e))
    t = rng.normal(size=(2, 9, 11, 32)).astype(np.float32) * 3
    for amax in (np.float32(2.5), np.float32(0.7)):   # 0.7: many clips
        np.testing.assert_array_equal(
            tint8.quantize_act(torch.from_numpy(t), amax).numpy(),
            np.asarray(jint8.quantize_act(jnp.asarray(t), amax)))
    ts = [t, -np.abs(t[..., :5]), t[:1] * 0.01]
    np.testing.assert_array_equal(
        tint8.record_amax([torch.from_numpy(a) for a in ts]).numpy(),
        np.asarray(jint8.record_amax([jnp.asarray(a) for a in ts])))


@pytest.mark.parametrize("c,g,shape", [(16, 8, (1, 32, 32)),
                                       (64, 32, (1, 16, 24))])
def test_plain_int8_drdb_matches_pallas_kernel(c, g, shape):
    """``drdb_int8_ref`` (image layout, dilation 2) against the TPU kernel
    on phase halo strips (8 rows, halo 5), merged back; the halo rows are
    dropped, so every image row is an owned row of one strip."""
    x, w, amax = _case(5, c, g, shape)
    xs, m = _phase_strips(phase_split(jnp.asarray(x)), 8, 5)
    ys = drdb_strips_int8_pallas(xs, _jax(w), m, jnp.asarray(amax),
                                 interpret=True)
    expect = np.asarray(merge_strips(ys, shape[0], 8, 5))
    got = tint8.drdb_int8_ref(_nchw(x), _quantized(w, amax))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), expect,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("c,g,shape", [(16, 8, (2, 12, 14)),
                                       (64, 32, (1, 10, 9))])
def test_plain_int8_drdb_vs_bf16_partials_chain(c, g, shape):
    """Against the JAX chain, whose partial sums are rounded to bf16: the
    gap between the two partial-sum widths stays below 0.05."""
    x, w, amax = _case(6, c, g, shape)
    expect = np.asarray(jint8.drdb_chain_int8(jnp.asarray(x), _jax(w), None,
                                              jnp.asarray(amax), dil=2))
    got = tint8.drdb_int8(_nchw(x), _quantized(w, amax))  # CPU: plain
    assert np.abs(got.permute(0, 2, 3, 1).numpy() - expect).max() < 0.05


def test_calibrate_mode_records_jax_amax():
    """A DRDB in calibrate mode returns the float path's output and
    records the running abs-max of (x, r1..r5) as the JAX package does."""
    x, w, amax = _case(7, 64, 32, (2, 12, 16))
    block = DRDB(quant="calibrate").eval()
    dconvs, bottleneck = _port(w)
    with torch.no_grad():
        for i, (wt, bs) in enumerate(dconvs):
            getattr(block, f"Dcov{i + 1}").weight.copy_(wt)
            getattr(block, f"Dcov{i + 1}").bias.copy_(bs)
        block.conv.weight.copy_(bottleneck[0])
        block.conv.bias.copy_(bottleneck[1])
        xt = _nchw(x)
        out = block(xt)
        np.testing.assert_array_equal(
            out.numpy(), drdb_block(xt, dconvs, bottleneck).numpy())
        block(xt * 0.5)     # a smaller batch leaves the running max
    np.testing.assert_allclose(block.amax.numpy(), amax, rtol=1e-6)
    block.set_quant("int8")
    got = block(xt)
    want = tint8.drdb_int8_ref(xt, _quantized(w, amax))
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), atol=1e-6)


def test_int8_path_is_serving_only():
    x, w, amax = _case(8, 16, 8, (1, 8, 8))
    xt = _nchw(x).clone().requires_grad_(True)
    out = tint8.drdb_int8(xt, _quantized(w, amax))
    with pytest.raises(NotImplementedError, match="serving-only"):
        out.sum().backward()


def test_packing_as_the_kernel_reads_it():
    """The growth kernel's schedule on the packed weights, written out in
    torch: per conv, per 32-channel chunk and per tap, the zero-padded
    window of the int8 buffer times that chunk's weights as the wgmma B
    descriptor walks them ([k granule of 16][n][16]: the granule 512
    bytes on, n 16 bytes on), one accumulator set per source (x: chunks
    0-1), all folded after the last chunk into f32 partial sums by the
    packed column scales in the reference's order, then requantised; then
    the tail's [224] x [64][224] product. Each source's accumulators equal
    the plain version's exactly, and so do the buffer and output."""
    x, w, amax = _case(9, 64, 32, (1, 7, 9))
    q = _quantized(w, amax)
    xt = _nchw(x)
    want_feat = tint8.drdb_int8_growth_ref(xt, q)
    assert q.wpk.numel() == 20 * 9 * 32 * 32 and q.svk.shape == (5, 5, 32)
    feat = torch.zeros_like(want_feat)
    feat[..., :64] = want_feat[..., :64]        # the entry quantise
    h, wd = x.shape[1:3]
    off = 0
    for t in range(5):
        xp = F.pad(feat.double(), (0, 0, 2, 2, 2, 2))
        accs = torch.zeros((t + 1, 1, h, wd, 32), dtype=torch.float64)
        for c in range(2 + t):
            # [tap][granule][n][16] -> [tap][n][k = 16 granule + e]
            wc = q.wpk[off:off + 9 * 32 * 32].reshape(9, 2, 32, 16).permute(
                0, 2, 1, 3).reshape(9, 32, 32).double()
            off += 9 * 32 * 32
            for tap in range(9):
                ky, kx = divmod(tap, 3)
                accs[max(c - 1, 0)] += xp[:, 2 * ky:2 * ky + h,
                                          2 * kx:2 * kx + wd,
                                          32 * c:32 * c + 32] @ wc[tap].t()
        for s in range(t + 1):
            lo, hi = (0, 64) if s == 0 else (32 + 32 * s, 64 + 32 * s)
            plain = tint8._iconv(want_feat[..., lo:hi], q.kq[s])
            assert torch.equal(accs[s].float(),
                               plain[..., 32 * (t - s):32 * (t - s + 1)])
        pre = accs[0].float() * q.svk[t, 0] + q.bias[32 * t:32 * t + 32]
        for s in range(1, t + 1):
            pre = pre + accs[s].float() * q.svk[t, s]
        r = torch.round(torch.relu(pre) * q.invs[t + 1])
        feat[..., 64 + 32 * t:96 + 32 * t] = torch.clamp(r, -127, 127)
    assert torch.equal(feat, want_feat)
    acc = (feat.double().reshape(-1, 224) @ q.kbq.double().t()).float()
    assert q.kbq.shape == (64, 224) and q.kbq.is_contiguous()
    out = xt.permute(0, 2, 3, 1).reshape(-1, 64) + \
        torch.relu(acc * q.svb + q.bb)
    want = tint8.drdb_int8_tail_ref(xt, want_feat, q)
    assert torch.equal(out, want.permute(0, 2, 3, 1).reshape(-1, 64))


def test_growth_packing_by_index_formula():
    """Every byte of ``pack_int8_growth`` read back by its flat index
    equals the int8 weight it stands for: conv t, chunk c, tap (ky, kx),
    output n, chunk channel k = 16 gr + e sits at base_t + 9216 c + 1024
    tap + 512 gr + 16 n + e ([chunk][tap][granule][n][16], the wgmma B
    operand), where base_t counts the earlier convs' chunks; chunks 0-1
    are x's channels, chunk c >= 2 is r_{c-1}."""
    x, w, amax = _case(10, 64, 32, (1, 4, 5))
    q = _quantized(w, amax)
    wpk = q.wpk.numpy()
    n, k, ky, kx = np.meshgrid(np.arange(32), np.arange(32), np.arange(3),
                               np.arange(3), indexing="ij")
    flat = 1024 * (3 * ky + kx) + 512 * (k // 16) + 16 * n + k % 16
    base = 0
    for t in range(5):
        for c in range(2 + t):
            s = 0 if c < 2 else c - 1
            k0 = 32 * c if s == 0 else 0
            want = q.kq[s][32 * (t - s) + n, k0 + k, ky, kx].numpy()
            np.testing.assert_array_equal(wpk[base + flat], want)
            base += 9216
    assert base == wpk.size


B, H, W = 2, 32, 32


@pytest.fixture(scope="module")
def pipelines():
    """A small JointPipeline on both sides (mit_b0, 32x32, batch 2), the
    fusion weights at the reference modules' scale; the JAX side
    quantised by its own quantize_for_serving."""
    rng = np.random.default_rng(3)
    ir = rng.uniform(0, 1, (B, H, W, 1)).astype(np.float32)
    vis = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    jmodel = JaxJointPipeline("mit_b0", num_classes=9)
    np_vars = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(3), jnp.asarray(ir), jnp.asarray(vis)))
    np_vars["params"]["fusion"] = torch_default_init(
        np_vars["params"]["fusion"], rng)
    variables = jax.tree.map(jnp.asarray, np_vars)
    cal = (jnp.asarray(ir), jnp.asarray(vis))
    _, qvars = jax_serving.quantize_for_serving(jmodel, variables, cal)
    jserve = jax_serving.make_serving_fn(jmodel, variables,
                                         int8_calibration=cal)
    rgb_e, pred_e = (np.asarray(t) for t in jserve(*cal))
    port = JointPipeline("mit_b0", num_classes=9)
    port.load_state_dict(state_dict_from_jax(np_vars["params"],
                                             np_vars["batch_stats"]))
    return (port, jax.tree.map(np.asarray, qvars["quant"]),
            torch.from_numpy(ir), torch.from_numpy(vis), rgb_e, pred_e)


def test_int8_serving_matches_jax(pipelines):
    """The port's calibrated int8 serving against the JAX package's on the
    same weights and inputs. The port's calibration gives the JAX amaxes
    (rtol 1e-5). The two differ by the partial-sum width (bf16 in the JAX
    chain, f32 here: a relative 2^-9 on each partial sum, and the requant
    flips it causes, in four DRDBs), so fused_rgb is held within 5e-3
    (6.4e-4 measured) and pred, which flips only where the fused image
    moves the logits across a near-tie, to >= 99% of pixels (100%
    measured)."""
    port, jquant, ir, vis, rgb_e, pred_e = pipelines
    qport = serving.quantize_for_serving(port, (ir, vis), device="cpu")
    assert all(d.quant == "none" for d in port.fusion.drdbs())
    for n, d in enumerate(qport.fusion.drdbs(), start=1):
        assert d.quant == "int8"
        np.testing.assert_allclose(d.amax.numpy(),
                                   jquant["fusion"][f"drdb{n}"]["amax"],
                                   rtol=1e-5)
    serve = serving.make_serving_fn(port, device="cpu",
                                    int8_calibration=(ir, vis))
    rgb, pred = serve(ir, vis)
    assert np.abs(rgb.numpy() - rgb_e).max() < 5e-3
    assert (pred.numpy() == pred_e).mean() >= 0.99


def test_int8_with_jax_amax_tracks_float(pipelines):
    """The JAX amaxes carried onto the port (``load_quant_from_jax``) give
    the same scales on both sides; the port's int8 fused Y stays within
    the JAX package's sanity bound of its float output (rmse < 0.25 std,
    test_int8.py:140-145; 0.0099 std measured). The int8 buffers do not
    enter the state dict, and a dtype move keeps them exact."""
    port, jquant, ir, vis, _, _ = pipelines
    keys = set(port.state_dict())
    with torch.inference_mode():
        _, y_float = port.fuse(ir, vis)
    qport = JointPipeline("mit_b0", num_classes=9)
    qport.load_state_dict(port.state_dict(), strict=True)
    load_quant_from_jax(qport, jquant)
    qport.set_quant("int8")
    assert set(qport.state_dict()) == keys
    d1 = qport.fusion.DRDB1
    amax, wpk = d1.amax.clone(), d1.int8_wpk.clone()
    qport.to(torch.bfloat16).float()
    assert d1.amax.dtype == torch.float32 and torch.equal(d1.amax, amax)
    assert d1.int8_svk.dtype == torch.float32
    assert torch.equal(d1.int8_wpk, wpk)
    qport.load_state_dict(port.state_dict(), strict=True)
    qport.set_quant("int8")
    with torch.inference_mode():
        _, y_int8 = qport.fuse(ir, vis)
    rmse = (y_int8 - y_float).pow(2).mean().sqrt().item()
    assert rmse < 0.25 * y_float.std().item()


def test_serving_runs_on_the_card_unless_told_otherwise(pipelines,
                                                       monkeypatch):
    """Without ``device``, every serving entry point asks for the card,
    and raises where there is none; ``device="cpu"`` serves on the CPU."""
    port, _, ir, vis, _, _ = pipelines
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.make_serving_fn(port)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.precompute_guide_taps(port, vis)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.quantize_for_serving(port, (ir, vis))
    rgb = serving.make_serving_fn(port, with_seg=False, device="cpu")(ir, vis)
    assert rgb.device.type == "cpu" and rgb.shape == (B, H, W, 3)
