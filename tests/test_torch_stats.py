"""Per-develop statistics, normalization and tracing of pysp_tpu_torch
against pysp_tpu.

The JAX functions run op by op (``jax.disable_jit()``). Tolerances:
``bayer_normalize`` bit-equal; the statistics within 1e-6 relative, the
fractions exact (the count over n, one float32 division; jitted, XLA
multiplies by the reciprocal of n and can land one ulp away);
``develop_with_stats``'s image as ``develop``'s, its statistics as the JAX
package's within 1e-6 relative on the sensor and 1e-5 on the output (the
develops differ by up to 1e-5). ``p99`` is ``numpy.quantile(x, 0.99)``'s
linear interpolation with the position taken in float64; the JAX package
takes it in float32, which agrees while ``0.99 * (n - 1)`` is exact in
float32 and rounds to the next even index above 2**24 elements.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysp_tpu.core.frame import RawFrame as JaxFrame
from pysp_tpu.core.normalization import bayer_normalize as jax_bayer_normalize
from pysp_tpu.pipeline.develop import DevelopConfig as JaxConfig
from pysp_tpu.pipeline.develop import develop_with_stats as jax_develop_with_stats
from pysp_tpu.utils import tracing as JT
from pysp_tpu_torch import (
    DevelopConfig,
    RawFrame,
    bayer_normalize,
    develop,
    develop_with_stats,
)
from pysp_tpu_torch.utils import tracing as TT
from pysp_tpu_torch.utils.testing import make_scene, mosaic_rggb

torch.set_num_threads(1)

CAM = np.array([[0.9, -0.2, -0.1], [-0.3, 1.1, 0.2], [0.0, -0.4, 1.3]], np.float32)
WB = np.array([0.45, 1.0, 0.62], np.float32)
FIELDS = ("bayer", "cam_mat", "cam_white", "wb_neutral", "ev", "lim_sat")
FRACTIONS = ("clip_high_frac", "clip_low_frac", "sat_frac", "neg_frac")


@pytest.mark.parametrize("shape", [(48, 64), (2, 3, 16, 20)])
def test_bayer_normalize_bit_equal(shape):
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 4200, shape).astype(np.uint16)
    black = np.array([256, 250, 260, 255], np.float32)
    sat = np.array([3839, 3800, 3900, 3850], np.float32)
    want = np.asarray(jax_bayer_normalize(jnp.asarray(counts), jnp.asarray(black),
                                          jnp.asarray(sat)))
    got = bayer_normalize(torch.from_numpy(counts.astype(np.int32)), black, sat)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() == 0.0 and got.max() == 1.0


def _stats_close(got, want, rtol):
    for k, w in want.items():
        g = got[k].cpu().numpy()
        if k in FRACTIONS:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)
        else:
            np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=0, err_msg=k)


@pytest.mark.parametrize("lim_sat", [1.0, 1.5])
def test_bayer_stats_match_jax(lim_sat):
    rng = np.random.default_rng(1)
    bayer = np.clip(rng.normal(0.5, 0.4, (96, 128)) * lim_sat, 0, lim_sat).astype(np.float32)
    with jax.disable_jit():
        want = JT.bayer_stats(jnp.asarray(bayer), jnp.asarray(lim_sat, jnp.float32))
    got = TT.bayer_stats(torch.from_numpy(bayer), torch.tensor(lim_sat))
    assert set(got) == set(want)
    _stats_close(got, want, 1e-6)
    assert 0.0 < float(got["clip_high_frac"]) < 1.0 and 0.0 < float(got["clip_low_frac"]) < 1.0


def test_rgb_stats_match_jax():
    rgb = np.random.default_rng(2).uniform(-0.1, 1.1, (64, 80, 3)).astype(np.float32)
    with jax.disable_jit():
        want = JT.rgb_stats(jnp.asarray(rgb))
    got = TT.rgb_stats(torch.from_numpy(rgb))
    assert set(got) == set(want)
    _stats_close(got, want, 1e-6)
    # the population std, as jnp.std
    np.testing.assert_allclose(got["std_rgb"].numpy(), rgb.reshape(-1, 3).std(axis=0),
                               rtol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 7, 101, 5000])
def test_p99_is_numpys_linear_quantile(n):
    x = np.random.default_rng(n).random(n).astype(np.float32)
    got = float(TT.bayer_stats(torch.from_numpy(x), torch.tensor(1.0))["p99"])
    want = float(np.quantile(x.astype(np.float64), 0.99))
    assert abs(got - want) <= 1e-6 * max(abs(want), 1.0)
    with jax.disable_jit():
        jax_p99 = float(JT.bayer_stats(jnp.asarray(x), jnp.asarray(1.0))["p99"])
    assert abs(got - jax_p99) <= 1e-6 * max(abs(want), 1.0)


def test_p99_beyond_torch_quantiles_limit():
    """torch.quantile refuses more than 2**24 elements; a 4200x4200 mosaic
    (17.64 M) goes, with ties of quantized counts, as numpy computes it."""
    rng = np.random.default_rng(3)
    x = (rng.integers(0, 4096, (4200, 4200)) / 4095).astype(np.float32)
    assert x.size > 2 ** 24
    got = TT.bayer_stats(torch.from_numpy(x), torch.tensor(1.0))
    want = float(np.quantile(x, 0.99))
    assert abs(float(got["p99"]) - want) <= 1e-6
    count = int((x >= 1.0).sum())
    assert float(got["clip_high_frac"]) == np.float32(count) / np.float32(x.size)


def _frames(h=96, w=128, seed=3):
    rgb = make_scene(h, w, seed=seed) * 1.4
    bayer = np.clip(mosaic_rggb(rgb.astype(np.float32)), 0, 1).astype(np.float32)
    jf = JaxFrame.synthetic(bayer, cam_mat=CAM, wb_neutral=WB)
    tf = RawFrame.from_numpy(*(np.asarray(getattr(jf, k)) for k in FIELDS), device="cpu")
    return jf, tf


@pytest.mark.parametrize("highlights", ["clip", "reconstruct"])
def test_develop_with_stats_matches_jax(highlights):
    jf, tf = _frames()
    with jax.disable_jit():
        want_out, want = jax_develop_with_stats(jf, JaxConfig(highlights=highlights))
    out, stats = develop_with_stats(tf, DevelopConfig(highlights=highlights))
    assert torch.equal(out, develop(tf, DevelopConfig(highlights=highlights)))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-5, rtol=0)
    assert set(stats) == set(want) == {"sensor", "output"}
    _stats_close(stats["sensor"], want["sensor"], 1e-6)
    assert set(stats["output"]) == set(want["output"])
    for k, w in want["output"].items():
        np.testing.assert_allclose(stats["output"][k].numpy(), np.asarray(w), atol=1e-5, rtol=0)
    # the host form the CLI prints
    text = json.dumps({k: {kk: vv.numpy().tolist() for kk, vv in v.items()}
                       for k, v in stats.items()})
    assert len(json.loads(text)["output"]["mean_rgb"]) == 3


def test_stage_timer_and_trace(tmp_path):
    """The port's spans time its stages; inside ``trace`` each is a profiler
    range of its name in ``trace.json``, recorded or not."""
    TT.drain()
    with TT.trace(str(tmp_path / "trace")):
        with TT.span("develop/tail"):
            torch.ones(4) * 2
    assert TT.drain().spans == []          # the recorder stayed off
    assert TT.span("after") is TT.span("the trace")   # and no range is left open
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any(e.get("name") == "develop/tail" for e in trace["traceEvents"])
