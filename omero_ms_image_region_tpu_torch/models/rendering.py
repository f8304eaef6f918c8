"""Rendering definition value objects.

Replaces the consumed surface of ``ome.model.display.RenderingDef`` /
``ChannelBinding`` / ``QuantumDef`` and the canonical ``Family`` /
``RenderingModel`` enumerations the reference worker verticle holds
(``ImageRegionVerticle.java:72-81``), plus the default-settings construction
in ``ImageRegionRequestHandler.java:258-300`` (createRenderingDef).

Everything here is host-side metadata; the render kernels consume a packed
array-of-struct view produced by ``ops.render.pack_settings``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace
from typing import List, Optional, Tuple

from .pixels import Pixels, pixels_type_range


class Family(enum.Enum):
    """Quantization family (= omeis.providers.re.quantum family strategies).

    The reference enumerates exactly these four
    (``ImageRegionVerticle.java:72-76``).
    """

    LINEAR = "linear"
    POLYNOMIAL = "polynomial"
    LOGARITHMIC = "logarithmic"
    EXPONENTIAL = "exponential"

    @property
    def index(self) -> int:
        return _FAMILY_INDEX[self]


_FAMILY_INDEX = {
    Family.LINEAR: 0,
    Family.POLYNOMIAL: 1,
    Family.LOGARITHMIC: 2,
    Family.EXPONENTIAL: 3,
}


class RenderingModel(enum.Enum):
    """Color model (= RenderingModel enumeration, greyscale/rgb;
    ``ImageRegionVerticle.java:78-81``)."""

    GREYSCALE = "greyscale"
    RGB = "rgb"


class Projection(enum.IntEnum):
    """Projection algorithm ids (= ome.api.IProjection constants consumed at
    ``ImageRegionCtx.java:377-387``)."""

    MAXIMUM_INTENSITY = 0
    MEAN_INTENSITY = 1
    SUM_INTENSITY = 2


@dataclass
class QuantumDef:
    """Codomain interval + bit resolution (= ome.model.display.QuantumDef).

    Defaults mirror createRenderingDef
    (``ImageRegionRequestHandler.java:273-276``): cd interval [0, 255],
    8-bit resolution.
    """

    cd_start: int = 0
    cd_end: int = 255
    bit_resolution: int = 255


@dataclass
class ChannelBinding:
    """Per-channel rendering settings (= ome.model.display.ChannelBinding).

    Field defaults mirror createRenderingDef
    (``ImageRegionRequestHandler.java:281-298``): coefficient 1.0, no noise
    reduction, linear family, window from the type range, first three
    channels active, red color.
    """

    active: bool = True
    input_start: float = 0.0
    input_end: float = 255.0
    family: Family = Family.LINEAR
    coefficient: float = 1.0
    noise_reduction: bool = False
    red: int = 255
    green: int = 0
    blue: int = 0
    alpha: int = 255
    lut: Optional[str] = None          # e.g. "cool.lut"; None => RGBA color
    reverse_intensity: bool = False    # codomain chain ReverseIntensityContext


@dataclass
class RenderingDef:
    """Full rendering settings for one pixels set
    (= ome.model.display.RenderingDef)."""

    pixels: Pixels
    model: RenderingModel = RenderingModel.GREYSCALE
    quantum: QuantumDef = field(default_factory=QuantumDef)
    channel_bindings: List[ChannelBinding] = field(default_factory=list)

    def active_channels(self) -> List[int]:
        return [i for i, cb in enumerate(self.channel_bindings) if cb.active]

    def copy(self) -> "RenderingDef":
        return RenderingDef(
            pixels=self.pixels,
            model=self.model,
            quantum=replace(self.quantum),
            channel_bindings=[replace(cb) for cb in self.channel_bindings],
        )


def restrict_to_active(rdef: RenderingDef
                       ) -> Tuple[RenderingDef, List[int]]:
    """Drop inactive channel bindings so a renderer never reads or
    composites planes that contribute nothing.

    The reference reads all active channels inside
    ``renderAsPackedInt``; inactive channels in our kernels would be
    zero tables — correct but wasted I/O and device memory.  Order is
    preserved, so greyscale first-active semantics survive.
    """
    active = rdef.active_channels()
    out = rdef.copy()
    out.channel_bindings = [replace(rdef.channel_bindings[i])
                            for i in active]
    return out, active


def default_rendering_def(pixels: Pixels) -> RenderingDef:
    """Default settings for a pixels set.

    Mirrors ``ImageRegionRequestHandler.createRenderingDef``
    (``ImageRegionRequestHandler.java:258-300``): greyscale model, 8-bit
    quantum, and per channel: linear family, coefficient 1, window = pixel
    type range, active for the first three channels, red color, alpha 255.
    """
    bindings = []
    lo, hi = pixels_type_range(pixels.pixels_type)
    for c in range(pixels.size_c):
        bindings.append(
            ChannelBinding(
                active=(c < 3),
                input_start=lo,
                input_end=hi,
                family=Family.LINEAR,
                coefficient=1.0,
                red=255,
                green=0,
                blue=0,
                alpha=255,
            )
        )
    return RenderingDef(
        pixels=pixels,
        model=RenderingModel.GREYSCALE,
        quantum=QuantumDef(),
        channel_bindings=bindings,
    )
