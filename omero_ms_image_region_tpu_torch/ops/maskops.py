"""Shape-mask rasterization and the overlay blend.

Counterpart of the JAX package's ``ops/maskops.py``, which replaces the
pixel path of ``ShapeMaskRequestHandler`` (``:165-221``): 1-bit packed
mask bytes -> bit grid -> optional flip -> 2-entry palette raster.

Bit order matches ``ome.util.PixelData``'s "bit" accessor (MSB-first within
each byte, bits continuous across rows — ``convertBitsToBytes``,
``ShapeMaskRequestHandler.java:214-221``).  Flips always operate on the
unpacked bit grid (the JAX package's documented deviation from the
reference's byte-wise flip of aligned masks).

Host functions (numpy): :func:`unpack_mask_bits`, :func:`flip_mask`,
:func:`rasterize_mask`, :func:`overlay_masks_batch` (the integer formula;
the JAX package's native shortcut is not ported, it is bit-equal to the
formula), :func:`packed_nbytes` and :func:`pack_mask_payload`.

Device functions: :func:`rasterize_packed_batch` (K8a,
``kernels.workloads.mask_rasterize``) and :func:`overlay_masks_device`
(K8b, ``kernels.workloads.mask_overlay``).  Their tensor dispatchers
(:func:`rasterize_tensor`, :func:`overlay_tensor`) launch the kernel on a
CUDA tensor and run the plain PyTorch version beside it
(:func:`mask_rasterize_plain`, :func:`mask_overlay_plain`) on a CPU
tensor.  The contract is byte identity with the host functions: the
device grid is the host grid, and the caller feeds it to the same
``codecs.encode_mask_png`` tail.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..io.staging import pinned_copy
from ..models.mask import Mask


def unpack_mask_bits(data: bytes, width: int, height: int) -> np.ndarray:
    """Unpack 1-bit packed mask bytes to a u8[H, W] 0/1 grid."""
    total = width * height
    bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8))
    if bits.size < total:
        raise ValueError(
            f"Mask payload too small: {bits.size} bits < {width}x{height}"
        )
    return bits[:total].reshape(height, width)


def flip_mask(grid: np.ndarray, flip_horizontal: bool,
              flip_vertical: bool) -> np.ndarray:
    """Flip a mask grid (argument checks as ShapeMaskRequestHandler.flip
    ``:128-154``)."""
    if not flip_horizontal and not flip_vertical:
        return grid
    if grid is None:
        raise ValueError("Attempted to flip null image")
    if grid.shape[0] == 0 or grid.shape[1] == 0:
        raise ValueError("Attempted to flip image with 0 size")
    if flip_vertical:
        grid = grid[::-1, :]
    if flip_horizontal:
        grid = grid[:, ::-1]
    return np.ascontiguousarray(grid)


def rasterize_mask(mask: Mask, color=None, flip_horizontal: bool = False,
                   flip_vertical: bool = False) -> tuple:
    """Rasterize a mask to (palette_indices u8[H,W], rgba_palette (2,4)).

    Palette row 0 is fully transparent, row 1 the resolved fill color —
    the 2-entry IndexColorModel the reference builds (``:188-196``).
    """
    fill = mask.resolved_fill_color(color)
    grid = unpack_mask_bits(mask.bytes_, mask.width, mask.height)
    grid = flip_mask(grid, flip_horizontal, flip_vertical)
    palette = np.array([(0, 0, 0, 0), fill], dtype=np.uint8)
    return grid.astype(np.uint8), palette


def overlay_masks_batch(base_rgba: np.ndarray,
                        mask_grids: np.ndarray,
                        fills: np.ndarray) -> np.ndarray:
    """Alpha-composite a batch of masks over a batch of RGBA tiles:
    ``(base*(255-a) + fill*a + 127) // 255`` per RGB channel with
    per-pixel ``a = (mask != 0) * fill_alpha`` (any nonzero mask byte is
    "on"); alpha is kept.

    Args:
      base_rgba:  u8[B, H, W, 4]
      mask_grids: u8[B, H, W], nonzero = masked
      fills:      u8[B, 4] RGBA fill per mask
    """
    a = ((mask_grids != 0).astype(np.uint32)
         * fills[:, None, None, 3].astype(np.uint32))[..., None]
    ia = 255 - a
    base = base_rgba.astype(np.uint32)
    fill_rgb = fills[:, None, None, :3].astype(np.uint32)
    out = base_rgba.copy()
    out[..., :3] = ((base[..., :3] * ia + fill_rgb * a + 127)
                    // 255).astype(np.uint8)
    return out


def packed_nbytes(width: int, height: int) -> int:
    """Packed payload bytes one mask needs (bits continuous across rows)."""
    return (width * height + 7) // 8


def pack_mask_payload(data: bytes, width: int, height: int) -> np.ndarray:
    """Validate and normalize one packed payload to exactly
    ``packed_nbytes`` (the host path's size check; an over-long payload's
    trailing bytes are cut, the unpack slices them off anyway)."""
    need = packed_nbytes(width, height)
    buf = np.frombuffer(data, dtype=np.uint8)
    if buf.size * 8 < width * height:
        raise ValueError(
            f"Mask payload too small: {buf.size * 8} bits "
            f"< {width}x{height}")
    return buf[:need]


# ------------------------------------------------------------ device path

def mask_rasterize_plain(packed: torch.Tensor, width: int, height: int,
                         flip_h: bool = False,
                         flip_v: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K8a: shifts and masks, then
    ``torch.flip``.  u8[B, nbytes] -> u8[B, height, width] 0/1."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8,
                          device=packed.device)
    bits = (packed[:, :, None] >> shifts) & 1
    grids = bits.reshape(packed.shape[0], -1)[:, :width * height]
    grids = grids.reshape(packed.shape[0], height, width)
    dims = [d for d, on in ((1, flip_v), (2, flip_h)) if on]
    return torch.flip(grids, dims).contiguous() if dims else grids


def rasterize_tensor(packed: torch.Tensor, width: int, height: int,
                     flip_h: bool = False,
                     flip_v: bool = False) -> torch.Tensor:
    """K8a on a CUDA tensor, its plain version on a CPU tensor."""
    if packed.is_cuda:
        from ..kernels import workloads
        return workloads.mask_rasterize(packed, width, height, flip_h,
                                        flip_v)
    return mask_rasterize_plain(packed, width, height, flip_h, flip_v)


def rasterize_packed_batch(packed: np.ndarray, width: int, height: int,
                           flip_horizontal: bool = False,
                           flip_vertical: bool = False,
                           device: Union[str, torch.device] = "cuda"
                           ) -> np.ndarray:
    """Rasterize a stacked batch of same-shape packed masks on ``device``.

    Args:
      packed: u8[B, packed_nbytes(width, height)] (see
        ``pack_mask_payload``)
    Returns u8[B, H, W] 0/1 grids, host-resident, byte-identical to
    running ``unpack_mask_bits`` + ``flip_mask`` per member.  On CUDA the
    payloads cross through a pinned buffer and K8a makes the grids on the
    current stream.
    """
    if (flip_horizontal or flip_vertical) and (width == 0 or height == 0):
        raise ValueError("Attempted to flip image with 0 size")
    packed_t = pinned_copy(np.ascontiguousarray(packed, dtype=np.uint8),
                           device)
    grids = rasterize_tensor(packed_t, width, height, flip_horizontal,
                             flip_vertical)
    return grids.cpu().numpy()


def mask_overlay_plain(base: torch.Tensor, grids: torch.Tensor,
                       fills: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K8b: the integer formula of
    :func:`overlay_masks_batch` (u32 values, held in int32)."""
    a = ((grids != 0).to(torch.int32)
         * fills[:, None, None, 3].to(torch.int32))[..., None]
    b = base.to(torch.int32)
    fill_rgb = fills[:, None, None, :3].to(torch.int32)
    rgb = torch.div(b[..., :3] * (255 - a) + fill_rgb * a + 127, 255,
                    rounding_mode="floor").to(torch.uint8)
    return torch.cat([rgb, base[..., 3:]], dim=-1)


def overlay_tensor(base: torch.Tensor, grids: torch.Tensor,
                   fills: torch.Tensor) -> torch.Tensor:
    """K8b on CUDA tensors, its plain version on CPU tensors."""
    if base.is_cuda:
        from ..kernels import workloads
        return workloads.mask_overlay(base, grids, fills)
    return mask_overlay_plain(base, grids, fills)


def overlay_masks_device(base_rgba: np.ndarray, mask_grids: np.ndarray,
                         fills: np.ndarray,
                         device: Union[str, torch.device] = "cuda"
                         ) -> np.ndarray:
    """Device twin of :func:`overlay_masks_batch` (same shapes, bit-equal
    output): the three inputs cross through pinned buffers, K8b blends,
    the result comes back."""
    out = overlay_tensor(
        pinned_copy(np.ascontiguousarray(base_rgba, dtype=np.uint8), device),
        pinned_copy(np.ascontiguousarray(mask_grids, dtype=np.uint8), device),
        pinned_copy(np.ascontiguousarray(fills, dtype=np.uint8), device))
    return out.cpu().numpy()
