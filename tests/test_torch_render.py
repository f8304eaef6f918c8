"""Port render (plain PyTorch path) against the JAX package.

* ``pack_settings`` is the same numpy function in both packages.
* ``render_tile_batch_packed`` on CPU tensors against the Pallas kernels in
  interpret mode (settings shared across the batch) and against the XLA
  ``render_tile_batch_packed`` (per-tile settings that differ across the
  batch).

Tolerance per RGB byte: exact for the linear family; <= 1 for the curved
families (pow/log/exp differ by an ulp between PyTorch and XLA).
"""

import numpy as np
import pytest
import torch

from omero_ms_image_region_tpu.experimental.pallas_render import (
    render_tile_batch_packed_pallas,
)
from omero_ms_image_region_tpu.models.pixels import Pixels as JaxPixels
from omero_ms_image_region_tpu.models.rendering import (
    Family as JaxFamily, RenderingModel as JaxModel,
    default_rendering_def as jax_default_rdef,
)
from omero_ms_image_region_tpu.ops import render as jax_render
from omero_ms_image_region_tpu.ops.lut import LutProvider as JaxLutProvider
from omero_ms_image_region_tpu_torch.kernels import render as kernels
from omero_ms_image_region_tpu_torch.models.pixels import Pixels
from omero_ms_image_region_tpu_torch.models.rendering import (
    Family, RenderingModel, default_rendering_def,
)
from omero_ms_image_region_tpu_torch.ops import render as port_render
from omero_ms_image_region_tpu_torch.ops.lut import LutProvider
from omero_ms_image_region_tpu_torch.ops.quantum import to_float32

COLORS = [(255, 0, 0), (0, 255, 0), (0, 0, 255)]
FAMILIES = ["linear", "polynomial", "logarithmic", "exponential"]


def _lut_table(seed):
    return np.random.default_rng(seed).integers(
        0, 256, size=(256, 3)).astype(np.uint8)


def _rdef_pair(C=3, family="linear", model="rgb", inactive=(),
               reverse=(), alpha=255, lut_channel=None):
    """The same rendering spec built with each package's models."""
    out = []
    for Px, default, Fam, Model in (
            (JaxPixels, jax_default_rdef, JaxFamily, JaxModel),
            (Pixels, default_rendering_def, Family, RenderingModel)):
        rdef = default(Px(image_id=1, size_x=64, size_y=64, size_c=C,
                          pixels_type="uint16"))
        rdef.model = Model(model)
        for i, cb in enumerate(rdef.channel_bindings):
            cb.active = i not in inactive
            cb.red, cb.green, cb.blue = COLORS[i % 3]
            cb.alpha = alpha
            cb.input_start, cb.input_end = 200.0 + 100 * i, 50000.0 - 999 * i
            cb.family = Fam(family)
            cb.coefficient = {"polynomial": 1.3,
                              "exponential": 0.4}.get(family, 1.0)
            cb.reverse_intensity = i in reverse
            if i == lut_channel:
                cb.lut = "fire.lut"
        out.append(rdef)
    return out


def _providers():
    jax_lut, port_lut = JaxLutProvider(), LutProvider()
    jax_lut.add("fire.lut", _lut_table(5))
    port_lut.add("fire.lut", _lut_table(5))
    return jax_lut, port_lut


def _assert_close(got_i32, want_u32, family):
    got = got_i32.numpy().view(np.uint32).view(np.uint8).astype(int)
    want = np.asarray(want_u32).view(np.uint8).astype(int)
    assert got.shape == want.shape
    tol = 0 if family == "linear" else 1
    assert np.abs(got - want).max() <= tol


SPECS = {
    "rgb": {},
    "greyscale": {"model": "greyscale"},
    "inactive": {"inactive": (1,)},
    "reverse": {"reverse": (0, 2)},
    "alpha": {"alpha": 128},
    "lut": {"lut_channel": 1},
    "lut_greyscale": {"lut_channel": 0, "model": "greyscale"},
}


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_pack_settings_matches_jax(spec):
    jax_rdef, port_rdef = _rdef_pair(**SPECS[spec])
    jax_lut, port_lut = _providers()
    want = jax_render.pack_settings(jax_rdef, jax_lut)
    got = port_render.pack_settings(port_rdef, port_lut)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype
    # The LUT spec folds to tables; every other spec to ramp weights.
    assert got["tables"].ndim == (3 if spec == "lut" else 2)


def _raw(rng, B, C, H=16, W=64):
    return rng.integers(0, 65536, size=(B, C, H, W)).astype(np.uint16)


def _port_render(raw, settings_per_tile):
    """Port render from a list of per-tile pack_settings dicts."""
    t = [port_render.settings_to_tensors(s, "cpu")
         for s in settings_per_tile]
    stack = {k: torch.stack([ti[k] for ti in t])
             for k in ("window_start", "window_end", "family",
                       "coefficient", "reverse", "tables")}
    return port_render.render_tile_batch_packed(
        torch.from_numpy(raw), stack["window_start"], stack["window_end"],
        stack["family"], stack["coefficient"], stack["reverse"],
        t[0]["cd_start"], t[0]["cd_end"], stack["tables"])


@pytest.mark.parametrize("tables", ["ramp", "lut"])
@pytest.mark.parametrize("family", FAMILIES)
def test_render_matches_pallas_interpret(family, tables):
    jax_rdef, _ = _rdef_pair(family=family, reverse=(2,))
    s = jax_render.pack_settings(jax_rdef)
    if tables == "lut":
        s["tables"] = jax_render.build_channel_tables(jax_rdef)
    raw = _raw(np.random.default_rng(len(family)), 2, 3)
    want = render_tile_batch_packed_pallas(
        raw.astype(np.float32), s["window_start"], s["window_end"],
        s["family"], s["coefficient"], s["reverse"], s["cd_start"],
        s["cd_end"], s["tables"], interpret=True)
    got = _port_render(raw, [s, s])
    _assert_close(got, want, family)


@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("family", ["linear", "logarithmic"])
def test_render_matches_xla_per_tile_settings(spec, family):
    """Two tiles with different settings in one batch (the second tile's
    windows, reverse flags and colors differ from the first's)."""
    jax_lut, _ = _providers()
    first, _ = _rdef_pair(family=family, **SPECS[spec])
    second, _ = _rdef_pair(family=family, **SPECS[spec])
    for i, cb in enumerate(second.channel_bindings):
        cb.input_start, cb.input_end = 10.0 * i, 30000.0 + 7 * i
        cb.reverse_intensity = not cb.reverse_intensity
        cb.red, cb.green, cb.blue = COLORS[(i + 1) % 3]
    settings = [jax_render.pack_settings(r, jax_lut)
                for r in (first, second)]
    assert settings[0]["tables"].shape == settings[1]["tables"].shape
    raw = _raw(np.random.default_rng(17), 2, 3)
    stacked = {k: np.stack([s[k] for s in settings])
               for k in ("window_start", "window_end", "family",
                         "coefficient", "reverse", "tables")}
    want = jax_render.render_tile_batch_packed(
        raw, stacked["window_start"], stacked["window_end"],
        stacked["family"], stacked["coefficient"], stacked["reverse"],
        settings[0]["cd_start"], settings[0]["cd_end"], stacked["tables"])
    _assert_close(_port_render(raw, settings), want, family)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_render_storage_dtypes_match_xla(dtype):
    jax_rdef, _ = _rdef_pair()
    s = jax_render.pack_settings(jax_rdef)
    rng = np.random.default_rng(2)
    raw = (rng.integers(0, 256, size=(1, 3, 8, 16)) * 200).astype(dtype)
    want = jax_render.render_tile_batch_packed(
        raw, *(s[k][None] for k in ("window_start", "window_end",
                                    "family", "coefficient", "reverse")),
        s["cd_start"], s["cd_end"], s["tables"][None])
    _assert_close(_port_render(raw, [s]), want, "linear")


def test_unpack_rgba_matches_jax():
    packed = np.random.default_rng(1).integers(
        0, 2**32, size=(5, 7), dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(port_render.unpack_rgba(packed),
                                  jax_render.unpack_rgba(packed))
    np.testing.assert_array_equal(
        port_render.unpack_rgba(packed.view(np.int32)),
        jax_render.unpack_rgba(packed))


def test_raw_to_tensor_keeps_storage_types():
    u16 = np.array([[0, 1, 40000, 65535]], np.uint16)
    t = port_render.raw_to_tensor(u16, "cpu")
    assert t.dtype == torch.uint16
    np.testing.assert_array_equal(to_float32(t).numpy(),
                                  u16.astype(np.float32))
    assert port_render.raw_to_tensor(u16.astype(np.uint8), "cpu").dtype \
        == torch.uint8
    assert port_render.raw_to_tensor(u16.astype(np.int16), "cpu").dtype \
        == torch.float32


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper launches on CUDA or raises; it never falls back."""
    raw = torch.zeros((1, 2, 4, 4), dtype=torch.uint16)
    s = torch.zeros((1, 2))
    i = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.render_ramp(raw, s, s, i, s, i, torch.zeros((1, 2, 3)),
                            0, 255)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.render_lut(raw, s, s, i, s, i,
                           torch.zeros((1, 2, 256, 3)), 0, 255)
    assert kernels.LAUNCHES == {"render_ramp": 0, "render_lut": 0}


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_render.resolve_device()
    assert port_render.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("tables", ["ramp", "lut"])
def test_kernels_match_plain_on_the_card(tables):
    """On a CUDA card: the kernel against its plain version, all four
    families and a reversed channel, per-tile settings."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    rng = np.random.default_rng(4)
    B, C, H, W = 2, 4, 64, 96
    dev = torch.device("cuda")
    raw = port_render.raw_to_tensor(_raw(rng, B, C, H, W), dev)
    ws = torch.tensor(rng.uniform(0, 20000, (B, C)), dtype=torch.float32)
    args = [ws, ws + 30000, torch.arange(C).repeat(B, 1).int(),
            torch.full((B, C), 0.7), torch.tensor([[0, 1, 0, 0]] * B).int()]
    tab = (rng.uniform(0, 100, (B, C, 256, 3)) if tables == "lut"
           else rng.uniform(0, 0.5, (B, C, 3)))
    args = [a.to(dev) for a in args] + [0, 255,
                                       torch.tensor(tab, dtype=torch.float32,
                                                    device=dev)]
    got = port_render.render_tile_batch_packed(raw, *args)
    want = port_render.render_tile_batch_packed_plain(raw, *args)
    diff = (got.cpu().numpy().view(np.uint8).astype(int)
            - want.cpu().numpy().view(np.uint8).astype(int))
    assert np.abs(diff).max() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("tables", ["ramp", "lut"])
@pytest.mark.parametrize("shape", [(2, 4, 37, 45), (1, 3, 1, 7),
                                   (3, 9, 16, 24), (2, 80, 8, 24)])
def test_ramp_kernel_ragged_unaligned_and_many_channels_on_the_card(
        shape, tables):
    """On a CUDA card: each render kernel's scalar path (hw % 8 != 0, and
    a base that is not 16-byte aligned) and more channels than one load
    chunk holds, against the plain version.  80 LUT channels are more
    than the LUT kernel stages at once, so it takes them in chunks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    rng = np.random.default_rng(6)
    B, C, H, W = shape
    dev = torch.device("cuda")
    flat = port_render.raw_to_tensor(_raw(rng, 1, 1, 1, B * C * H * W + 1),
                                     dev).reshape(-1)
    ws = torch.tensor(rng.uniform(0, 20000, (B, C)), dtype=torch.float32)
    args = [ws, ws + 30000, (torch.arange(C) % 4).repeat(B, 1).int(),
            torch.full((B, C), 0.7), (torch.arange(C) % 3 == 1).repeat(
                B, 1).int()]
    tab = (rng.uniform(0, 100 / C, (B, C, 256, 3)) if tables == "lut"
           else rng.uniform(0, 0.5, (B, C, 3)))
    args = [a.to(dev) for a in args] + [0, 255, torch.tensor(
        tab, dtype=torch.float32, device=dev)]
    aligned, unaligned = flat[:-1].view(B, C, H, W), flat[1:].view(B, C, H, W)
    for raw in (aligned, unaligned):
        got = port_render.render_tile_batch_packed(raw, *args)
        want = port_render.render_tile_batch_packed_plain(raw, *args)
        diff = (got.cpu().numpy().view(np.uint8).astype(int)
                - want.cpu().numpy().view(np.uint8).astype(int))
        assert np.abs(diff).max() <= 1


def test_reciprocal_division_is_correctly_rounded():
    """The ramp kernel's divide(): with inv = RN(1/den), q = RN(a inv)
    and one fused correction give IEEE a / den.  Checked here on the same
    operation sequence (``ops.jpegenc.fma`` is a correctly rounded FMA)
    for integer windows, wide exponents and all-ones significands."""
    from omero_ms_image_region_tpu_torch.ops.jpegenc import fma

    rng = np.random.default_rng(10)
    n = 400_000
    den = np.concatenate([
        rng.integers(1, 65536, n).astype(np.float32),
        ((rng.random(n) + 1) * 2.0 ** rng.integers(-40, 40, n)).astype(
            np.float32),
        ((2 ** 24 - 1 - rng.integers(0, 64, n))
         * 2.0 ** (rng.integers(-60, 20, n) - 23)).astype(np.float32)])
    a = ((rng.random(3 * n) * 2 - 1) * den).astype(np.float32)
    a[:n] = np.floor(a[:n] * np.sign(a[:n])).astype(np.float32)
    inv = (np.float32(1) / den).astype(np.float32)
    q = torch.from_numpy(a * inv)
    a_t, den_t, inv_t = (torch.from_numpy(x) for x in (a, den, inv))
    got = fma(fma(-q, den_t, a_t), inv_t, q).numpy()
    want = (a / den).astype(np.float32)
    np.testing.assert_array_equal(got, want)
