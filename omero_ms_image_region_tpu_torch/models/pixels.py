"""Pixels metadata value objects.

Replaces the consumed surface of ``ome.model.core.Pixels`` /
``ome.model.enums.PixelsType`` and ``omeis.providers.re.metadata.StatsFactory``
(reference call sites: ``ImageRegionRequestHandler.java:281-298`` builds
default channel windows from ``StatsFactory.initPixelsRange(pixels)``;
``ProjectionService.java:66-73`` uses the type's bit size and value range).

The reference derives the default channel window from the pixel type's value
range; here that is a static dtype table (``PIXELS_TYPES``), which is exactly
what ``StatsFactory`` computes for integer types.  Float types default to the
unit interval, a policy choice for data that nearly always arrives with
explicit windows.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class PixelsType:
    """An OMERO pixel type: name, numpy dtype, value range, bit size."""

    value: str            # OMERO enumeration value, e.g. "uint16"
    dtype: str            # numpy dtype name
    min_value: float
    max_value: float
    bit_size: int


def _int_type(value: str, dtype: str) -> PixelsType:
    info = np.iinfo(dtype)
    return PixelsType(value, dtype, float(info.min), float(info.max),
                      info.bits)


PIXELS_TYPES = {
    "int8": _int_type("int8", "int8"),
    "uint8": _int_type("uint8", "uint8"),
    "int16": _int_type("int16", "int16"),
    "uint16": _int_type("uint16", "uint16"),
    "int32": _int_type("int32", "int32"),
    "uint32": _int_type("uint32", "uint32"),
    # Float ranges: see module docstring.
    "float": PixelsType("float", "float32", 0.0, 1.0, 32),
    "double": PixelsType("double", "float64", 0.0, 1.0, 64),
    # 1-bit masks (ShapeMask path); stored packed, expanded on use.
    "bit": PixelsType("bit", "uint8", 0.0, 1.0, 1),
}


def pixels_type_range(pixels_type: str) -> Tuple[float, float]:
    """Default channel window for a pixel type (= StatsFactory.initPixelsRange)."""
    pt = PIXELS_TYPES[pixels_type]
    return (pt.min_value, pt.max_value)


@dataclass
class Pixels:
    """Pixels set metadata (dimensions + type), detached from any ORM.

    Mirrors the fields of ``ome.model.core.Pixels`` the reference actually
    reads: sizeX/Y/Z/C/T, pixels type, dimension order, image id
    (``ImageRegionRequestHandler.java:543-553`` constructs one with exactly
    these).
    """

    image_id: int
    pixels_type: str                 # key into PIXELS_TYPES
    size_x: int
    size_y: int
    size_z: int = 1
    size_c: int = 1
    size_t: int = 1
    dimension_order: str = "XYZCT"
    pixels_id: Optional[int] = None
    # Physical channel metadata the reference carries along (unused by math).
    channel_names: Tuple[str, ...] = field(default_factory=tuple)

    def to_json(self) -> dict:
        """The pixels-metadata cache's value (the JAX package's form:
        channel names are not cached)."""
        return {
            "image_id": self.image_id,
            "pixels_type": self.pixels_type,
            "size_x": self.size_x,
            "size_y": self.size_y,
            "size_z": self.size_z,
            "size_c": self.size_c,
            "size_t": self.size_t,
            "dimension_order": self.dimension_order,
            "pixels_id": self.pixels_id,
        }

    @classmethod
    def from_json(cls, d: dict) -> "Pixels":
        return cls(
            image_id=d["image_id"],
            pixels_type=d["pixels_type"],
            size_x=d["size_x"],
            size_y=d["size_y"],
            size_z=d.get("size_z", 1),
            size_c=d.get("size_c", 1),
            size_t=d.get("size_t", 1),
            dimension_order=d.get("dimension_order", "XYZCT"),
            pixels_id=d.get("pixels_id"),
        )
