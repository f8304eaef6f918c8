"""Rendering metadata value objects (numpy-only copies of the JAX
package's ``models``).  Plain dataclasses, free of any ORM/session
machinery."""

from .pixels import PixelsType, Pixels, PIXELS_TYPES, pixels_type_range
from .rendering import (
    Family,
    RenderingModel,
    QuantumDef,
    ChannelBinding,
    RenderingDef,
    default_rendering_def,
)

__all__ = [
    "PixelsType",
    "Pixels",
    "PIXELS_TYPES",
    "pixels_type_range",
    "Family",
    "RenderingModel",
    "QuantumDef",
    "ChannelBinding",
    "RenderingDef",
    "default_rendering_def",
]
