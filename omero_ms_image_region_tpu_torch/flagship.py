"""The flagship workload, defined once.

BASELINE.md config 3 — 4-channel uint16 WSI tiles rendered to RGB.
``chip_smoke.py`` builds its pyramid and its kernel checks from it.
"""

from __future__ import annotations

import numpy as np

from .models.pixels import Pixels
from .models.rendering import (RenderingDef, RenderingModel,
                               default_rendering_def)

FLAGSHIP_COLORS = ((255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0))
FLAGSHIP_WINDOW = (100.0, 40000.0)


def flagship_rdef(n_channels: int = 4,
                  plane: int = 8192) -> RenderingDef:
    """RGB rendering settings for the n-channel 16-bit WSI workload."""
    pixels = Pixels(
        image_id=1, size_x=plane, size_y=plane, size_z=1,
        size_c=n_channels, size_t=1, pixels_type="uint16",
    )
    rdef = default_rendering_def(pixels)
    rdef.model = RenderingModel.RGB
    for i, cb in enumerate(rdef.channel_bindings):
        cb.active = True
        cb.red, cb.green, cb.blue = FLAGSHIP_COLORS[i % len(FLAGSHIP_COLORS)]
        cb.input_start, cb.input_end = FLAGSHIP_WINDOW
    return rdef


def synthetic_wsi_tiles(rng: np.random.Generator, B: int, C: int,
                        H: int, W: int, blobs: int = 12) -> np.ndarray:
    """Synthetic microscopy-like uint16 tiles: cell blobs + sensor noise.

    Gaussian blobs (separable outer products, so generation stays cheap at
    1024^2) over a dim background with additive read noise — the content
    class the 4-ch WSI benchmark config describes, rather than uniform
    random noise, which no microscope produces and which no codec or cache
    behaves representatively on.
    """
    cy = rng.uniform(0, H, size=(B, C, blobs, 1))
    cx = rng.uniform(0, W, size=(B, C, blobs, 1))
    s = rng.uniform(H / 40, H / 8, size=(B, C, blobs, 1))
    amp = rng.uniform(5_000, 35_000, size=(B, C, blobs))
    ys = np.exp(-((np.arange(H)[None, None, None, :] - cy) ** 2)
                / (2 * s * s)).astype(np.float32)
    xs = np.exp(-((np.arange(W)[None, None, None, :] - cx) ** 2)
                / (2 * s * s)).astype(np.float32)
    img = np.einsum("bcky,bckx,bck->bcyx", ys, xs,
                    amp.astype(np.float32), optimize=True)
    img += 200.0 + rng.normal(0, 300.0, size=img.shape)
    return np.clip(img, 0, 65535).astype(np.uint16)
