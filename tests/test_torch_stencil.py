"""Stencil ops of pysp_tpu_torch against pysp_tpu.ops.stencil.

Every op here is bit-exact: the pads move data, the correlations and box sums
take their taps in the JAX package's order with float32 products and sums, and
a median is a selection. The CUDA kernels' median networks
(csrc/median5_columns.cuh) are checked against the networks the JAX package
builds.
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
MEDIAN5_COLUMNS_CUH = (Path(T.__file__).resolve().parent.parent / "csrc"
                       / "median5_columns.cuh")


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
@pytest.mark.parametrize("name", ["gaussian_blur3", "box_sum3", "median5", "box_blur3",
                                  "median3"])
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


def _cuh_function(name):
    """The compare-exchanges of one network of median5_columns.cuh, in order,
    and the wires its outputs are read from ({output index: wire})."""
    text = MEDIAN5_COLUMNS_CUH.read_text()
    body = re.search(r"void " + name + r"\(.*?\n}\n", text, re.S).group(0)
    ops = [(kind.lower(), int(i), int(j)) for kind, i, j in
           re.findall(r"^\s*MED5_(CMP|MIN|MAX)\((\d+), (\d+)\);", body, re.M)]
    outs = {int(k): int(i) for k, i in re.findall(r"^\s*\w+\[(\d+)\] = w\[(\d+)\];", body, re.M)}
    return ops, outs


def _run_network(name, wires):
    """One network of median5_columns.cuh on numpy arrays, as the header runs
    it on floats: fminf and fmaxf are np.minimum and np.maximum on these
    values (no NaN)."""
    ops, outs = _cuh_function(name)
    w = list(wires)
    for kind, i, j in ops:
        a, b = w[i], w[j]
        if kind == "cmp":
            w[i], w[j] = np.minimum(a, b), np.maximum(a, b)
        elif kind == "min":
            w[i] = np.minimum(a, b)
        else:
            w[j] = np.maximum(a, b)
    return [w[outs[k]] for k in sorted(outs)] if outs else w


def _sorted_fields(n, seed, ties):
    """n sorted fields (n, 6, 7): random floats or small integers (ties)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 4, (n, 6, 7)) if ties else rng.random((n, 6, 7))
    return np.sort(x.astype(np.float32), axis=0)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("network", ["sort5", "merge5x5", "merge10x10_mid"])
def test_median5_columns_networks_are_the_jax_packages(network, ties):
    """sort5, merge5x5 and merge10x10_mid of median5_columns.cuh give the JAX
    package's sort5, merge_sorted and merge_sorted(ranks=_Q_RANKS) outputs bit
    for bit, on random floats and on integer ties."""
    if network == "sort5":
        x = np.random.default_rng(7).integers(0, 4, (5, 6, 7)).astype(np.float32) if ties \
            else np.random.default_rng(7).random((5, 6, 7)).astype(np.float32)
        got, want = _run_network("sort5", list(x)), J.sort5([jnp.asarray(v) for v in x])
        assert len(got) == 5
    elif network == "merge5x5":
        a, b = _sorted_fields(5, 8, ties), _sorted_fields(5, 9, ties)
        got = _run_network("merge5x5", list(a) + list(b))
        want = J.merge_sorted([jnp.asarray(v) for v in a], [jnp.asarray(v) for v in b])
        assert len(got) == 10
    else:
        a, b = _sorted_fields(10, 10, ties), _sorted_fields(10, 11, ties)
        got = _run_network("merge10x10_mid", list(a) + list(b))
        picked = J.merge_sorted([jnp.asarray(v) for v in a], [jnp.asarray(v) for v in b],
                                ranks=J._Q_RANKS)
        want = [picked[r] for r in sorted(J._Q_RANKS)]
        assert len(got) == 6
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w_))


def _median5_strip(window):
    """median5_strip<N> of median5_columns.cuh in numpy on a (5, N + 4, ...)
    window (rows, columns): the N medians of its 5x5 windows."""
    text = MEDIAN5_COLUMNS_CUH.read_text()
    for line in ("for (int c = 0; c < N + 4; ++c) sort5(col[c]);",
                 "for (int c = 0; c < N + 2; ++c) merge5x5(col[c], col[c + 1], pair[c]);",
                 "merge10x10_mid(pair[j], pair[j + 2], q);",
                 "med[j] = median_of_20_and_5(q, col[j + 4]);",
                 "t = fmaxf(t, fminf(q[1 + k], side[4 - k]));"):
        assert line in text
    n = window.shape[1] - 4
    cols = [_run_network("sort5", list(window[:, c])) for c in range(n + 4)]
    pairs = [_run_network("merge5x5", cols[c] + cols[c + 1]) for c in range(n + 2)]
    med = []
    for j in range(n):
        q = _run_network("merge10x10_mid", pairs[j] + pairs[j + 2])
        t = q[0]
        for k in range(5):
            t = np.maximum(t, np.minimum(q[1 + k], cols[j + 4][4 - k]))
        med.append(t)
    return med


@pytest.mark.parametrize("strip", [4, 8])
@pytest.mark.parametrize("values", ["integer_ties", "floats"])
def test_median5_strip_selects_the_median(values, strip):
    """median5_strip's medians of a 5 x (N + 4) window are np.median of its N
    5x5 windows, in the strips of four of the AHD and postprocess kernels and
    the strips of eight of the median5 kernel, on small integers (many ties)
    and on random floats."""
    rng = np.random.default_rng(6)
    shape = (5, strip + 4, 1000)
    window = (rng.integers(0, 7, shape) if values == "integer_ties"
              else rng.random(shape)).astype(np.float32)
    for j, got in enumerate(_median5_strip(window)):
        want = np.median(window[:, j:j + 5].reshape(25, -1), axis=0)
        np.testing.assert_array_equal(got, want)
