"""Image flip op.

Replaces ``ImageRegionRequestHandler.flip`` (``:616-642``) — the reference's
O(w*h) per-pixel CPU loop — with ``torch.flip`` on the render's device, so
only the flipped tile crosses back to the host.

Validation semantics match the reference: flipping a null or zero-sized image
raises; no-op when neither flag is set.
"""

from __future__ import annotations

import torch


def flip_image(img: torch.Tensor, flip_horizontal: bool = False,
               flip_vertical: bool = False) -> torch.Tensor:
    """Flip an [H, W, ...] image. Mirrors the reference's argument checks
    (``ImageRegionRequestHandler.java:619-627``)."""
    if not flip_horizontal and not flip_vertical:
        return img
    if img is None:
        raise ValueError("Attempted to flip null image")
    if img.shape[0] == 0 or img.shape[1] == 0:
        raise ValueError("Attempted to flip image with 0 size")
    dims = []
    if flip_vertical:
        dims.append(0)  # rows
    if flip_horizontal:
        dims.append(1)  # columns
    return torch.flip(img, dims=dims)
