"""pysp_tpu_torch.parallel against pysp_tpu.parallel on the CPU, and the
shard runner itself.

The JAX functions run jitted (as tests/test_parallel.py runs them) on the
eight virtual CPU devices that tests/conftest.py sets up; the port runs the
same layouts on a mesh of ``"cpu"`` repeated, one thread a shard. Every input
is built once in NumPy from a seed and handed to both. One case here for
each non-slow case of tests/test_parallel.py, at its sizes. Tolerances:

- Fast and Draft: within 1e-5 of the JAX result (a jitted and an eager JAX
  develop differ by 1.6e-6 on these frames);
- the config-5 composition (CA removal, Fast, warp): within 3e-5 of the JAX
  result, the JAX test's own gate for the composition. The port's eager
  composition is 5.4e-6 from JAX's eager one on these frames (the Fast
  develop carries CA's 2.4e-7), and JAX's jit adds its own; 1.5e-5 measured;
- Best: >= 40 dB against JAX's jitted result (its fused CIELAB is 41 dB from
  op by op, ROADMAP.md);
- against the port's own monolithic composition, the JAX test's gate on the
  rows it names (2e-5 or 3e-5), where 0 is expected: the same inputs through
  the same functions (``-s`` prints the maxima);
- the heal inside the runner: within 1e-6 of the interpret-mode Pallas heal
  inside ``shard_map`` (tests/test_torch_corrections.py's bound for the
  masked fill) and bit-equal to the port's heal of each item alone.

Left out: the two ``slow`` interpret-mode megakernel tests, which exercise
the TPU kernel.
"""
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysp_tpu.const import QualityDemosaic as JQ
from pysp_tpu.core.frame import RawFrame as JaxFrame
from pysp_tpu.parallel.mesh import make_mesh as jax_mesh
from pysp_tpu.parallel import pipeline_sharded as JPS
from pysp_tpu.parallel import spatial as JSP
from pysp_tpu.pipeline.develop import DevelopConfig as JaxDevelopConfig
from pysp_tpu.pipeline.pipeline import PipelineConfig as JaxPipelineConfig
from pysp_tpu_torch import (
    DevelopConfig,
    PipelineConfig,
    Poly3CorrectionModel,
    QualityDemosaic,
    RawFrame,
    apply_opcode_3_warp,
    develop,
    develop_burst_sharded,
    develop_burst_spatial,
    develop_pipeline,
    develop_spatial,
    encode_warp_rectilinear,
    make_mesh,
    remove_ca_from_raw,
    stack_frames,
)
from pysp_tpu_torch.ops import cuda_kernels as K
from pysp_tpu_torch.parallel import shard as S
from pysp_tpu_torch.parallel.mesh import BATCH_AXIS, SPATIAL_AXIS, Mesh
from pysp_tpu_torch.parallel.pipeline_sharded import develop_hdr_sharded, develop_pipeline_sharded
from pysp_tpu_torch.pipeline.pipeline import _correct_one
from pysp_tpu_torch.utils.testing import make_scene, mosaic_rggb, psnr

torch.set_num_threads(1)

FIELDS = ("bayer", "cam_mat", "cam_white", "wb_neutral", "ev", "lim_sat")
TIER_ATOL = 1e-5
COMPOSED_ATOL = 3e-5
BEST_MIN_PSNR = 40.0
WARP_COEFFS = (1.004, -0.008, 0.0015, 0.0, 0.0002, -0.0001)


def cpu_mesh(shape):
    return make_mesh(shape, ["cpu"] * (shape[0] * shape[1]))


def _pair(bayer, **meta):
    """The same frame for both packages: (JAX frame, port frame on the CPU)."""
    jf = JaxFrame.synthetic(jnp.asarray(np.asarray(bayer, np.float32)), **meta)
    tf = RawFrame.from_numpy(*(np.asarray(getattr(jf, k)) for k in FIELDS),
                             is_hdr=jf.is_hdr, device="cpu")
    return jf, tf


def _bursts(pairs):
    jax_burst = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[j for j, _ in pairs])
    return jax_burst, stack_frames([t for _, t in pairs], device="cpu")


def _close(got, want, atol, what):
    err = float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())
    print(f"{what}: max abs {err:.3g} (gate {atol:g})")
    assert err <= atol, f"{what}: {err}"


def _q(name):
    return getattr(JQ, name), getattr(QualityDemosaic, name)


# --- the shard runner -------------------------------------------------------------------


def _shard_values(mesh, seed=0):
    """One (3, 5) float tensor for each position, in flat order, and the
    stacked (n_b, n_sp, 3, 5) array of them."""
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(mesh.shape[BATCH_AXIS], mesh.shape[SPATIAL_AXIS], 3, 5))
    return torch.from_numpy(vals.astype(np.float32))


@pytest.mark.parametrize("axis", [BATCH_AXIS, SPATIAL_AXIS])
def test_collectives_match_reductions_over_the_stacked_shards(axis):
    mesh = cpu_mesh((2, 4))
    vals = _shard_values(mesh)

    def block(x):
        x = x[0, 0]                                  # this position's (3, 5)
        outs = (S.psum(x, axis), S.pmean(x, axis), S.pmin(x, axis), S.pmax(x, axis),
                S.all_gather(x, axis), S.all_gather(x, axis, axis=1, tiled=True),
                torch.tensor(float(S.axis_index(axis))), torch.tensor(float(S.psum(1, axis))))
        return tuple(o[None, None] for o in outs)

    spec = S.P(BATCH_AXIS, SPATIAL_AXIS)
    outs = S.shard_map(block, mesh, in_specs=(spec,), out_specs=(spec,) * 8)(vals)
    total, mean, low, high, stacked, tiled, index, size = outs
    for b in range(mesh.shape[BATCH_AXIS]):
        for s in range(mesh.shape[SPATIAL_AXIS]):
            group = vals[:, s] if axis == BATCH_AXIS else vals[b]
            assert torch.equal(total[b, s], group.sum(dim=0))
            assert torch.equal(mean[b, s], group.sum(dim=0) / len(group))
            assert torch.equal(low[b, s], group.amin(dim=0))
            assert torch.equal(high[b, s], group.amax(dim=0))
            assert torch.equal(stacked[b, s], group)
            assert torch.equal(tiled[b, s], torch.cat(list(group), dim=1))
            assert index[b, s].item() == (b if axis == BATCH_AXIS else s)
            assert size[b, s].item() == len(group)


def test_psum_of_a_tuple_and_of_bools():
    mesh = cpu_mesh((1, 4))
    flags = torch.tensor([[True, False], [True, True], [False, False], [True, False]])

    def block(f):
        a, n = S.psum((f[0], f[0].to(torch.float32) * 2), SPATIAL_AXIS)
        return a[None], n[None], torch.tensor([S.pmin(bool(f[0, 0]), SPATIAL_AXIS)])

    a, n, all_first = S.shard_map(block, mesh, in_specs=(S.P(SPATIAL_AXIS),),
                                  out_specs=(S.P(SPATIAL_AXIS),) * 3)(flags)
    assert a.dtype == torch.int32
    assert torch.equal(a, flags.sum(dim=0, dtype=torch.int32).expand(4, 2))
    assert torch.equal(n, 2 * flags.sum(dim=0).to(torch.float32).expand(4, 2))
    assert not all_first.any()


def test_ppermute_shifts_and_zero_fills():
    mesh = cpu_mesh((2, 4))
    vals = _shard_values(mesh, seed=1)

    def block(x):
        x = x[0, 0]
        down = S.ppermute(x, SPATIAL_AXIS, [(i, i + 1) for i in range(3)])
        swap = S.ppermute(x, BATCH_AXIS, [(0, 1), (1, 0)])
        return down[None, None], swap[None, None]

    spec = S.P(BATCH_AXIS, SPATIAL_AXIS)
    down, swap = S.shard_map(block, mesh, in_specs=(spec,), out_specs=(spec, spec))(vals)
    assert torch.equal(down[:, 0], torch.zeros_like(down[:, 0]))   # nobody sends to 0
    assert torch.equal(down[:, 1:], vals[:, :-1])
    assert torch.equal(swap, vals.flip(0))


def test_split_and_gather_by_specs_and_replicas():
    """In-specs split, a replicated input reaches every shard whole, and an
    out-spec that does not name an axis keeps that axis' position 0."""
    mesh = cpu_mesh((2, 4))
    x = torch.arange(2 * 8 * 3, dtype=torch.float32).reshape(2, 8, 3)
    rep = torch.tensor([7.0, 8.0])

    def block(xs, r):
        assert xs.shape == (1, 2, 3) and torch.equal(r, rep)
        return xs + 100 * S.axis_index(BATCH_AXIS), r.clone()

    got, r = S.shard_map(block, mesh, in_specs=(S.P(BATCH_AXIS, SPATIAL_AXIS), S.P()),
                         out_specs=(S.P(None, SPATIAL_AXIS), S.P()))(x, rep)
    assert torch.equal(got, x[:1])          # batch position 0's blocks only
    assert torch.equal(r, rep)
    with pytest.raises(ValueError, match="does not split into 4 equal parts"):
        S.shard_map(lambda a: a, mesh, in_specs=(S.P(None, SPATIAL_AXIS),),
                    out_specs=S.P())(torch.zeros(2, 6))


def _shard_threads():
    return [t for t in threading.enumerate() if t.name.startswith("shard-")]


def test_a_failing_shard_fails_the_call_fast_and_names_itself(monkeypatch):
    monkeypatch.setattr(S, "BARRIER_TIMEOUT", 60.0)
    mesh = cpu_mesh((2, 4))

    def block(x):
        if S.axis_index(BATCH_AXIS) == 1 and S.axis_index(SPATIAL_AXIS) == 1:
            raise ValueError("shard five broke")
        return S.psum(x, SPATIAL_AXIS)   # the others wait here until the abort

    t0 = time.perf_counter()
    with pytest.raises(S.ShardError, match=r"shard 5 \(mesh position batch 1, spatial 1\)"
                       r" raised ValueError: shard five broke") as err:
        S.shard_map(block, mesh, in_specs=(S.P(BATCH_AXIS, SPATIAL_AXIS),),
                    out_specs=S.P(BATCH_AXIS, SPATIAL_AXIS))(torch.ones(2, 4))
    assert time.perf_counter() - t0 < 10.0
    assert err.value.index == 5 and err.value.position == {BATCH_AXIS: 1, SPATIAL_AXIS: 1}
    assert isinstance(err.value.__cause__, ValueError)
    assert not _shard_threads()


def test_a_collective_some_shard_skips_times_out(monkeypatch):
    monkeypatch.setattr(S, "BARRIER_TIMEOUT", 0.5)
    mesh = cpu_mesh((1, 2))

    def block(x):
        if S.axis_index(SPATIAL_AXIS) == 0:
            return x
        return S.psum(x, SPATIAL_AXIS)

    t0 = time.perf_counter()
    with pytest.raises(S.ShardError, match="rendezvous was not complete within 0.5 s"):
        S.shard_map(block, mesh, in_specs=(S.P(None, SPATIAL_AXIS),),
                    out_specs=S.P(None, SPATIAL_AXIS))(torch.ones(1, 2))
    assert time.perf_counter() - t0 < 10.0
    assert not _shard_threads()


def test_collectives_outside_a_block_raise():
    with pytest.raises(RuntimeError, match="outside a shard_map block"):
        S.psum(torch.ones(2), SPATIAL_AXIS)
    with pytest.raises(ValueError, match="unknown mesh axis"):
        S.P("rows")


def test_make_mesh_shapes_and_refusals():
    mesh = make_mesh((2, 3), ["cpu"] * 6)
    assert mesh.shape == {"batch": 2, "spatial": 3} and mesh.size == 6
    assert isinstance(mesh, Mesh) and mesh.device_at(1, 2) == torch.device("cpu")
    assert make_mesh(devices=["cpu"] * 3).shape == {"batch": 3, "spatial": 1}
    with pytest.raises(ValueError, match=r"mesh shape \(2, 4\) needs 8 devices"):
        make_mesh((2, 4), ["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="none is present"):
            make_mesh((1, 1))


def test_launch_counts_survive_racing_threads():
    """Shard threads count launches at once: no increment is lost."""
    before = K.launch_counts["remap"]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [K._count_launch("remap")
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        K.launch_counts["remap"] = before + 16 * 2000
    assert K.launch_counts["remap"] == before + 16 * 2000


# --- the sharded develops against the JAX package ----------------------------------------


def test_spatial_sharded_develop_matches_monolithic():
    jf, tf = _pair(mosaic_rggb(make_scene(128, 64, seed=7)))
    jq, tq = _q("Best")
    want = np.asarray(JSP.develop_spatial(jf, JaxDevelopConfig(quality=jq), jax_mesh((1, 4)),
                                          halo=16))
    got = develop_spatial(tf, DevelopConfig(quality=tq), cpu_mesh((1, 4)), halo=16)
    mono = develop(tf, DevelopConfig(quality=tq))
    assert got.shape == mono.shape == want.shape
    p = psnr(got.numpy(), want)
    print(f"Best sharded, port vs JAX: {p:.2f} dB")
    assert p >= BEST_MIN_PSNR
    _close(got[16:-16], mono[16:-16], 2e-5, "Best sharded vs the port's monolithic, interior")
    assert psnr(got.numpy(), mono.numpy()) > 45


@pytest.mark.parametrize("quality", ["Draft", "Fast"])
def test_spatial_sharded_draft_and_fast(quality):
    jf, tf = _pair(mosaic_rggb(make_scene(64, 48, seed=8)))
    jq, tq = _q(quality)
    want = np.asarray(JSP.develop_spatial(jf, JaxDevelopConfig(quality=jq), jax_mesh((1, 2)),
                                          halo=16))
    got = develop_spatial(tf, DevelopConfig(quality=tq), cpu_mesh((1, 2)), halo=16)
    _close(got, want, TIER_ATOL, f"{quality} sharded, port vs JAX")
    mono = develop(tf, DevelopConfig(quality=tq))
    _close(got[16:-16], mono[16:-16], 2e-5, f"{quality} sharded vs the port's monolithic")


def test_burst_sharded_develop():
    pairs = [_pair(mosaic_rggb(make_scene(32, 32, seed=10 + i)), ev=9.0 + i * 0.1)
             for i in range(8)]
    jb, tb = _bursts(pairs)
    jq, tq = _q("Fast")
    want = np.asarray(JSP.develop_burst_sharded(jb, JaxDevelopConfig(quality=jq),
                                                jax_mesh((8, 1))))
    got = develop_burst_sharded(tb, DevelopConfig(quality=tq), cpu_mesh((8, 1)))
    assert got.shape == (8, 32, 32, 3)
    _close(got, want, TIER_ATOL, "burst sharded, port vs JAX")
    for i in (0, 3, 7):
        _close(got[i], develop(pairs[i][1], DevelopConfig(quality=tq)), 2e-5,
               f"burst frame {i} vs the port's develop")


def test_burst_spatial_develop():
    """develop_burst_spatial (the slow JAX test's layout, at Best with the
    port's develop) against JAX's jitted one and the port's monolithic."""
    pairs = [_pair(mosaic_rggb(make_scene(64, 48, seed=30 + i))) for i in range(2)]
    jb, tb = _bursts(pairs)
    jq, tq = _q("Best")
    want = np.asarray(JSP.develop_burst_spatial(jb, JaxDevelopConfig(quality=jq),
                                                jax_mesh((2, 2)), halo=16))
    got = develop_burst_spatial(tb, DevelopConfig(quality=tq), cpu_mesh((2, 2)), halo=16)
    assert got.shape == (2, 64, 48, 3)
    for i in range(2):
        assert psnr(got[i].numpy(), want[i]) >= BEST_MIN_PSNR
        _close(got[i, 16:-16], develop(pairs[i][1], DevelopConfig(quality=tq))[16:-16], 2e-5,
               f"burst x spatial frame {i} vs the port's develop, interior")


def test_heal_inside_the_runner_matches_per_item_and_the_pallas_heal():
    """The counterpart of the Pallas-inside-shard_map guard: the heal's
    wrapper (its plain version here) inside the runner, against each item
    healed alone and the interpret-mode Pallas heal inside shard_map."""
    from jax.sharding import PartitionSpec as JP

    from pysp_tpu.ops.pallas_kernels import masked_fill_pallas

    rng = np.random.default_rng(33)
    n = 2
    chan = rng.random((n, 4, 8, 128)).astype(np.float32)
    mask = rng.random((n, 4, 8, 128)) < 3e-3
    mask[0, 0, 0, 0] = mask[1, 2, 7, 127] = True
    mask[0, 1, 5:8, 10:13] = True

    want = np.asarray(jax.jit(jax.shard_map(
        lambda c, m: jax.lax.map(lambda a: masked_fill_pallas(a[0], a[1], tile_h=8,
                                                              interpret=True), (c, m)),
        mesh=jax_mesh((n, 1)), in_specs=(JP("batch"), JP("batch")), out_specs=JP("batch"),
        check_vma=False,
    ))(jnp.asarray(chan), jnp.asarray(mask)))

    def heal(c, m):
        return torch.stack([K.heal_kernel(ci, mi) for ci, mi in zip(c, m)])

    spec = S.P(BATCH_AXIS)
    got = S.shard_map(heal, cpu_mesh((n, 1)), in_specs=(spec, spec),
                      out_specs=spec)(torch.from_numpy(chan), torch.from_numpy(mask))
    for i in range(n):
        assert torch.equal(got[i], K.heal_kernel(torch.from_numpy(chan[i]),
                                                 torch.from_numpy(mask[i])))
    _close(got, want, 1e-6, "heal in the runner vs the Pallas heal in shard_map")


def test_combined_mesh_axes():
    """2x4 mesh: develop_spatial replicated over batch, rows over spatial."""
    mesh = cpu_mesh((2, 4))
    assert mesh.shape["batch"] == 2 and mesh.shape["spatial"] == 4
    jf, tf = _pair(mosaic_rggb(make_scene(64, 32, seed=20)))
    jq, tq = _q("Fast")
    want = np.asarray(JSP.develop_spatial(jf, JaxDevelopConfig(quality=jq), jax_mesh((2, 4)),
                                          halo=8))
    got = develop_spatial(tf, DevelopConfig(quality=tq), mesh, halo=8)
    _close(got, want, TIER_ATOL, "2x4 mesh, port vs JAX")
    _close(got[8:-8], develop(tf, DevelopConfig(quality=tq))[8:-8], 2e-5,
           "2x4 mesh vs the port's monolithic")


# --- the full pipeline under the mesh ----------------------------------------------------


def _monolithic(frame, cfg, model_r, model_b, warp_block, interp, flat=None, dark=None):
    """The port's unsharded composition of one frame."""
    f = _correct_one(frame, cfg, flat, dark, None)
    if model_r is not None or model_b is not None:
        f = remove_ca_from_raw(f, model_r, model_b)
    img = develop(f, cfg.develop)
    return img if warp_block is None else apply_opcode_3_warp(img, warp_block,
                                                               interpolation=interp)


def test_pipeline_sharded_config5_parity():
    from pysp_tpu.correct.ca.models import Poly3CorrectionModel as JaxPoly3
    from pysp_tpu.warp.opcodes import encode_warp_rectilinear as jax_encode

    n, h, w = 8, 48, 64
    block = encode_warp_rectilinear([WARP_COEFFS] * 3, (0.5, 0.5))
    assert block == jax_encode([WARP_COEFFS] * 3, (0.5, 0.5))
    rng = np.random.default_rng(40)
    pairs = [_pair(mosaic_rggb(make_scene(h, w, seed=40 + i)), ev=9.0 + 0.05 * i)
             for i in range(n)]
    jb, tb = _bursts(pairs)
    flat_np = np.clip(1.0 - 0.2 * rng.random((h, w)), 0.2, 1).astype(np.float32)
    jflat, tflat = _pair(flat_np)
    jq, tq = _q("Fast")
    want = np.asarray(JPS.develop_pipeline_sharded(
        jb, jax_mesh((8, 1)), JaxPipelineConfig(develop=JaxDevelopConfig(quality=jq),
                                                flat_field=True),
        ca_model_r=JaxPoly3(0.01), ca_model_b=JaxPoly3(0.01), warp_block=block,
        warp_interpolation="bilinear", flat=jflat))
    cfg = PipelineConfig(develop=DevelopConfig(quality=tq), flat_field=True)
    model = Poly3CorrectionModel(0.01)
    got = develop_pipeline_sharded(tb, cpu_mesh((8, 1)), cfg, ca_model_r=model,
                                   ca_model_b=model, warp_block=block,
                                   warp_interpolation="bilinear", flat=tflat)
    assert got.shape == (n, h, w, 3) and bool(torch.isfinite(got).all())
    _close(got, want, COMPOSED_ATOL, "config 5 batch-sharded, port vs JAX")
    for i in (0, 3, 7):
        _close(got[i], _monolithic(pairs[i][1], cfg, model, model, block, "bilinear",
                                   flat=tflat), 3e-5, f"config 5 frame {i} vs the port's")


def _hot_burst(n, h, w, seed, hot_everywhere, hot_in_few, few):
    pairs = []
    for i in range(n):
        b = mosaic_rggb(make_scene(h, w, seed=seed + i)) * 0.6 + 0.1
        b[hot_everywhere] = 1.0
        if i < few:
            b[hot_in_few] = 1.0
        pairs.append(_pair(b.astype(np.float32)))
    return pairs


def test_pipeline_sharded_consensus_masks_psum():
    """A pixel hot in >= the ratio of ALL frames heals on every shard; one
    hot in 3 of 8 frames does not."""
    pairs = _hot_burst(8, 32, 32, 60, (9, 13), (21, 5), 3)
    jb, tb = _bursts(pairs)
    jq, tq = _q("Draft")
    jcfg = JaxPipelineConfig(develop=JaxDevelopConfig(quality=jq), repair_hot_pixels=True,
                             hot_pixel_shared_ratio=0.6)
    cfg = PipelineConfig(develop=DevelopConfig(quality=tq), repair_hot_pixels=True,
                         hot_pixel_shared_ratio=0.6)
    want = np.asarray(JPS.develop_pipeline_sharded(jb, jax_mesh((4, 1)), jcfg))
    got = develop_pipeline_sharded(tb, cpu_mesh((4, 1)), cfg)
    _close(got, want, TIER_ATOL, "consensus batch-sharded, port vs JAX")
    _close(got, develop_pipeline(tb, cfg), 3e-5, "consensus vs the port's develop_pipeline")


def test_hdr_sharded_config4_parity():
    pairs = []
    for i in range(4):
        b = np.clip(mosaic_rggb(make_scene(64, 48, seed=70 + i)) * (0.5 + 0.2 * i), 0, 1)
        pairs.append(_pair(b.astype(np.float32), ev=9.0 + i))
    jb, tb = _bursts(pairs)
    jq, tq = _q("Fast")
    halo = 8
    want = np.asarray(JPS.develop_hdr_sharded(
        jb, jax_mesh((2, 4)), JaxPipelineConfig(develop=JaxDevelopConfig(quality=jq),
                                                fuse_hdr=True), halo=halo))
    cfg = PipelineConfig(develop=DevelopConfig(quality=tq), fuse_hdr=True)
    got = develop_hdr_sharded(tb, cpu_mesh((2, 4)), cfg, halo=halo)
    _close(got, want, TIER_ATOL, "config 4 sharded, port vs JAX")
    mono = develop_pipeline(tb, cfg)
    assert got.shape == mono.shape
    _close(got[halo:-halo], mono[halo:-halo], 3e-5, "config 4 sharded vs the port's, interior")
    assert psnr(got.numpy(), mono.numpy()) > 38


def test_hdr_sharded_with_one_frame_a_shard_is_the_unsharded_fuse():
    """With one bracket a batch shard, the psum is the unsharded sum over the
    burst (one stacked reduction), so the rows away from the frame's edges
    equal ``develop_pipeline``'s bit for bit, the consensus heal included."""
    pairs = _hot_burst(4, 64, 48, 110, (9, 13), (41, 5), 1)
    tb = stack_frames([t for _, t in pairs], device="cpu")
    tb = tb.replace(ev=torch.tensor([9.0, 10.0, 11.0, 12.0]))
    cfg = PipelineConfig(develop=DevelopConfig(quality=QualityDemosaic.Fast), fuse_hdr=True,
                         repair_hot_pixels=True, hot_pixel_shared_ratio=0.5)
    got = develop_hdr_sharded(tb, cpu_mesh((4, 2)), cfg)
    _close(got[16:-16], develop_pipeline(tb, cfg)[16:-16], 0.0,
           "config 4, one frame a shard, vs the port's, interior")


def test_pipeline_sharded_rejects_fuse_hdr():
    pairs = [_pair(mosaic_rggb(make_scene(16, 16, seed=80 + i))) for i in range(2)]
    jb, tb = _bursts(pairs)
    with pytest.raises(ValueError, match="fuse_hdr") as jax_err:
        JPS.develop_pipeline_sharded(jb, jax_mesh((2, 1)), JaxPipelineConfig(fuse_hdr=True))
    with pytest.raises(ValueError, match="fuse_hdr") as err:
        develop_pipeline_sharded(tb, cpu_mesh((2, 1)), PipelineConfig(fuse_hdr=True))
    assert str(err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="develop_hdr_sharded is the fuse_hdr path"):
        develop_hdr_sharded(tb, cpu_mesh((2, 1)), PipelineConfig())
