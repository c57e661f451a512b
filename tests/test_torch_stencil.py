"""Stencil ops of pysp_tpu_torch against pysp_tpu.ops.stencil.

Every op here is bit-exact: the pads move data, the correlations and box sums
take their taps in the JAX package's order with float32 products and sums, and
a median is a selection. The CUDA kernels' median network (csrc/median5.cuh)
is checked against the network the JAX package builds.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysp_tpu.ops import stencil as J
from pysp_tpu.ops.phase_kernels import BayerPatternPosition, get_rgbg_kernel
from pysp_tpu_torch.ops import stencil as T

torch.set_num_threads(1)

SHAPES = [(16, 20), (13, 9), (2, 3, 24, 18)]
MEDIAN5_CUH = Path(T.__file__).resolve().parent.parent / "csrc" / "median5.cuh"


def _field(shape, seed=0):
    return np.random.default_rng(seed).normal(0.4, 0.3, shape).astype(np.float32)


def _both(fn_j, fn_t, x):
    return np.asarray(fn_j(jnp.asarray(x))), fn_t(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("pad", [1, 2, (1, 2), (0, 2, 1, 3)])
@pytest.mark.parametrize("name", ["pad_reflect", "pad_reflect101", "pad_replicate"])
def test_pads_bit_exact(name, pad, shape):
    x = _field(shape)
    want, got = _both(lambda a: getattr(J, name)(a, pad), lambda a: getattr(T, name)(a, pad), x)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(1, 7), (7, 1), (1, 1), (2, 1, 3)])
def test_pad_replicate_of_planes_thinner_than_the_pad(shape):
    """The replicate border of a plane with fewer rows or columns than the pad,
    as the JAX package pads it, and the 5x5 median on it."""
    x = _field(shape, seed=2)
    want, got = _both(lambda a: J.pad_replicate(a, 2), lambda a: T.pad_replicate(a, 2), x)
    np.testing.assert_array_equal(got, want)
    want, got = _both(J.median5, T.median5, x)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["gaussian_blur3", "box_sum3", "median5"])
def test_filters_bit_exact(name, shape):
    x = _field(shape, seed=3)
    want, got = _both(getattr(J, name), getattr(T, name), x)
    np.testing.assert_array_equal(got, want)


def test_median5_on_integer_ties_bit_exact():
    x = np.random.default_rng(4).integers(0, 4, (20, 24)).astype(np.float32)
    want, got = _both(J.median5, T.median5, x)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("position", list(BayerPatternPosition))
@pytest.mark.parametrize("border", ["reflect101", "reflect", "replicate"])
def test_filter2d_phase_kernels_bit_exact(position, border):
    x = _field((10, 14), seed=5)
    for k in get_rgbg_kernel(position):
        want, got = _both(
            lambda a: J.filter2d(a, k, border), lambda a: T.filter2d(a, k, border), x
        )
        np.testing.assert_array_equal(got, want)


def _cuh_network():
    ops = re.findall(r"^\s*MED5_(CMP|MIN|MAX)\((\d+), (\d+)\);", MEDIAN5_CUH.read_text(), re.M)
    return [(kind.lower(), int(i), int(j)) for kind, i, j in ops]


def test_median5_cuh_is_the_pruned_batcher_network():
    ops, target, _ = J._median_network(25)
    assert target == 12
    assert _cuh_network() == list(ops)


def test_median5_cuh_network_selects_the_median():
    values = np.random.default_rng(6).integers(0, 7, (25, 4000)).astype(np.float32)
    w = list(values)
    for kind, i, j in _cuh_network():
        a, b = w[i], w[j]
        if kind == "cmp":
            w[i], w[j] = np.minimum(a, b), np.maximum(a, b)
        elif kind == "min":
            w[i] = np.minimum(a, b)
        else:
            w[j] = np.maximum(a, b)
    np.testing.assert_array_equal(w[12], np.median(values, axis=0))
