"""Port ``ops.quantum.quantize`` against the JAX ``ops.quantum.quantize``.

Tolerance: exact for the linear family; +-1 for the curved families,
whose pow/log/exp differ between PyTorch's and XLA's CPU implementations
by an ulp, which can move a value across a rounding boundary.
"""

import numpy as np
import pytest
import torch

from omero_ms_image_region_tpu.ops import quantum as jax_quantum
from omero_ms_image_region_tpu_torch.ops import quantum as port_quantum

FAMILIES = {"linear": 0, "polynomial": 1, "logarithmic": 2,
            "exponential": 3}
# (window_start, window_end) per channel, for 3 channels.
WINDOWS = {
    "normal": [(200.0, 50000.0), (0.0, 65535.0), (1000.0, 3000.0)],
    "degenerate": [(300.0, 300.0), (0.0, 0.0), (65535.0, 65535.0)],
    "log_0_1": [(0.0, 1.0), (0.0, 1.0), (1.0, 1.0)],
    "inverted": [(50000.0, 200.0), (3000.0, 1000.0), (65535.0, 0.0)],
}


def _quantize_both(raw, windows, family, coef, cd=(0, 255)):
    ws = np.array([w[0] for w in windows], np.float32)
    we = np.array([w[1] for w in windows], np.float32)
    fam = np.full(len(windows), family, np.int32)
    k = np.full(len(windows), coef, np.float32)
    want = np.asarray(jax_quantum.quantize(raw, ws, we, fam, k, *cd))
    got = port_quantum.quantize(
        torch.from_numpy(raw), torch.from_numpy(ws), torch.from_numpy(we),
        torch.from_numpy(fam), torch.from_numpy(k), *cd)
    assert got.dtype == torch.int32
    return got.numpy(), want


def _raw(seed, windows):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 65536, size=(3, 16, 32)).astype(np.uint16)
    # Put the window edges (and their neighbours) into every plane.
    for c, (lo, hi) in enumerate(windows):
        for j, v in enumerate((lo, hi, lo + 1, hi - 1)):
            raw[c, 0, j] = np.clip(v, 0, 65535)
    return raw


@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_quantize_matches_jax(family, window):
    windows = WINDOWS[window]
    coef = {"polynomial": 1.3, "exponential": 0.4}.get(family, 1.0)
    got, want = _quantize_both(_raw(len(family) + len(window), windows),
                               windows, FAMILIES[family], coef)
    tol = 0 if family == "linear" else 1
    assert np.abs(got.astype(int) - want.astype(int)).max() <= tol


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_quantize_custom_codomain(family):
    windows = WINDOWS["normal"]
    coef = {"polynomial": 0.8, "exponential": 0.3}.get(family, 1.0)
    got, want = _quantize_both(_raw(7, windows), windows,
                               FAMILIES[family], coef, cd=(10, 200))
    assert got.min() >= 10 and got.max() <= 200
    tol = 0 if family == "linear" else 1
    assert np.abs(got.astype(int) - want.astype(int)).max() <= tol


def test_quantize_float_input_and_u8():
    rng = np.random.default_rng(3)
    windows = [(10.5, 200.25), (0.0, 255.0), (5.0, 5.0)]
    for raw in (rng.uniform(-20, 300, size=(3, 8, 8)).astype(np.float32),
                rng.integers(0, 256, size=(3, 8, 8)).astype(np.uint8)):
        got, want = _quantize_both(raw, windows, 0, 1.0)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cd", [(0, 1), (0, 5), (0, 255)])
def test_quantize_rounds_half_to_even(cd):
    """Values that land exactly on .5 round to even, as jnp.round does
    (a half-away-from-zero round would move each of them by one)."""
    windows = [(0.0, 2.0), (10.0, 12.0), (0.0, 510.0)]
    raw = np.zeros((3, 1, 4), np.uint16)
    raw[0, 0] = [0, 1, 2, 3]
    raw[1, 0] = [10, 11, 12, 13]
    raw[2, 0] = [255, 257, 1, 509]
    got, want = _quantize_both(raw, windows, 0, 1.0, cd=cd)
    np.testing.assert_array_equal(got, want)
    if cd == (0, 1):
        assert got[0, 0, 1] == 0 and got[1, 0, 1] == 0      # 0.5 -> 0
    if cd == (0, 5):
        assert got[0, 0, 1] == 2                             # 2.5 -> 2
