"""The tile render: settings packing, plain PyTorch composites, dispatch.

Counterpart of the JAX package's ``ops/render.py`` and
``experimental/pallas_render.py`` (replacing
``omeis.providers.re.Renderer.renderAsPackedInt``, reference call site
``ImageRegionRequestHandler.java:559``, and the settings application in
``updateSettings``, ``:689-741``).

The whole post-quantization chain — codomain maps (reverse intensity), LUT
vs RGBA color, alpha weighting, greyscale-vs-rgb model, channel activity —
is folded on the host (numpy) into either f32[C, 3] ramp weights
(:func:`build_ramp_weights`, every render with no LUT channel) or f32[C,
256, 3] tables (:func:`build_channel_tables`).  The device work is then

    quantize (window + family curve)  ->  reverse  ->  clip 0..255
    ->  per-channel weight or table lookup  ->  sequential sum over C
    ->  round, clip  ->  u32 pack  R | G<<8 | B<<16 | 0xFF<<24

On a CUDA tensor :func:`render_tile_batch_packed` launches the hand-written
kernels in ``kernels/render.py``; on a CPU tensor it runs the plain
PyTorch version below (:func:`render_tile_batch_packed_plain`), which is
also what the kernels are held against on the card.  Packed pixels are
carried as int32 (torch's uint32 coverage is thin) and viewed as uint32 on
the host.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from ..io.staging import pinned_copy
from ..models.rendering import RenderingDef, RenderingModel
from .quantum import quantize_float

_ALPHA_OPAQUE = -0x1000000     # 0xFF000000 as int32


def resolve_device(device: Union[str, torch.device] = "cuda"
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is asked for and there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def raw_to_tensor(raw: np.ndarray, device: Union[str, torch.device]
                  ) -> torch.Tensor:
    """Raw planes (numpy, storage dtype) -> a tensor on ``device``, staged
    through a pinned buffer (``io.staging.pinned_copy``).

    uint8 / uint16 / float32 keep their storage type (the kernels widen in
    registers, so u16 moves half the bytes of f32); uint16 crosses as an
    int16 view.  Any other pixel type is cast to float32 on the host, the
    same value the JAX package's on-device cast gives.
    """
    return pinned_copy(np.asarray(raw), device)


# ----------------------------------------------------------- settings (host)

def build_channel_tables(
    rdef: RenderingDef, lut_provider=None
) -> np.ndarray:
    """Fold color/LUT/alpha/model/codomain chain into (C, 256, 3) tables.

    Row semantics: ``rgb_contribution = table[channel][quantized_value]``.
    Inactive channels are all-zero rows, so the composite sum can run over
    every channel unconditionally.
    """
    C = len(rdef.channel_bindings)
    tables = np.zeros((C, 256, 3), dtype=np.float32)
    ramp = np.arange(256, dtype=np.float32)

    greyscale = rdef.model == RenderingModel.GREYSCALE
    first_active = next(
        (i for i, cb in enumerate(rdef.channel_bindings) if cb.active), None
    )

    for c, cb in enumerate(rdef.channel_bindings):
        if not cb.active:
            continue
        if greyscale:
            if c != first_active:
                continue
            # Grey ramp: quantized value becomes the grey level directly.
            table = np.stack([ramp, ramp, ramp], axis=-1)
        else:
            lut_table = None
            if cb.lut is not None and lut_provider is not None:
                lut_table = lut_provider.get(cb.lut)
            if lut_table is not None:
                table = lut_table.astype(np.float32) * (cb.alpha / 255.0)
            else:
                color = np.array(
                    [cb.red, cb.green, cb.blue], dtype=np.float32
                )
                table = (ramp[:, None] / 255.0) * color[None, :] * (
                    cb.alpha / 255.0
                )
        tables[c] = table
    return tables


def build_ramp_weights(rdef: RenderingDef, lut_provider=None):
    """Fold the color chain into per-channel linear weights, if possible.

    Every non-LUT channel's (C, 256, 3) table is a ramp — ``table[q] =
    q * w`` with ``w = color * alpha / 255**2`` (grey model: ``w = 1``) —
    so the composite collapses to one multiply-add per channel with no
    table at all.  Returns f32[C, 3] weights, or None when any active
    channel resolves an actual LUT file (the table path must run;
    :func:`build_channel_tables`).
    """
    C = len(rdef.channel_bindings)
    w = np.zeros((C, 3), dtype=np.float32)
    greyscale = rdef.model == RenderingModel.GREYSCALE
    first_active = next(
        (i for i, cb in enumerate(rdef.channel_bindings) if cb.active), None
    )
    for c, cb in enumerate(rdef.channel_bindings):
        if not cb.active:
            continue
        if greyscale:
            if c == first_active:
                w[c] = 1.0
            continue
        if (cb.lut is not None and lut_provider is not None
                and lut_provider.get(cb.lut) is not None):
            return None
        color = np.array([cb.red, cb.green, cb.blue], dtype=np.float32)
        w[c] = (color / 255.0) * (cb.alpha / 255.0)
    return w


def pack_settings(rdef: RenderingDef, lut_provider=None) -> dict:
    """Host-side packing of a RenderingDef into kernel arguments.

    Returns a dict of numpy arrays.  ``tables`` is f32[C, 3] ramp weights
    when no active channel uses a LUT (the ramp kernel), else the full
    f32[C, 256, 3] tables (the LUT kernel).
    """
    cbs = rdef.channel_bindings
    weights = build_ramp_weights(rdef, lut_provider)
    return {
        "window_start": np.array([cb.input_start for cb in cbs], np.float32),
        "window_end": np.array([cb.input_end for cb in cbs], np.float32),
        "family": np.array([cb.family.index for cb in cbs], np.int32),
        "coefficient": np.array([cb.coefficient for cb in cbs], np.float32),
        "reverse": np.array(
            [1 if cb.reverse_intensity else 0 for cb in cbs], np.int32
        ),
        "cd_start": np.int32(rdef.quantum.cd_start),
        "cd_end": np.int32(rdef.quantum.cd_end),
        "tables": (weights if weights is not None
                   else build_channel_tables(rdef, lut_provider)),
    }


def settings_to_tensors(settings: Dict[str, np.ndarray],
                        device: Union[str, torch.device]
                        ) -> Dict[str, Union[torch.Tensor, int]]:
    """:func:`pack_settings` output (numpy) -> tensors on ``device``.

    Array entries keep their shapes (a leading batch dim, where present,
    is kept too); ``cd_start``/``cd_end`` become Python ints.
    """
    out: Dict[str, Union[torch.Tensor, int]] = {}
    for key, value in settings.items():
        if key in ("cd_start", "cd_end"):
            out[key] = int(value)
        else:
            out[key] = torch.from_numpy(
                np.ascontiguousarray(value)).to(device)
    return out


# ------------------------------------------------------ plain composites

def _pack_u32(acc_r, acc_g, acc_b):
    """Round/clip the composites and pack to i32 holding the u32 RGBA
    layout (little-endian memory order R, G, B, A)."""
    def byte(v):
        return torch.clamp(torch.round(v), 0.0, 255.0).to(torch.int32)

    return (byte(acc_r) | (byte(acc_g) << 8) | (byte(acc_b) << 16)
            | _ALPHA_OPAQUE)


def composite_ramp_packed(q, weights):
    """Ramp composite: q f32[B, C, H, W] quantized values, weights
    f32[B, C, 3] -> i32[B, H, W] packed.

    The sum over channels runs in order c = 0..C-1 with one rounding per
    multiply and per add, as the Pallas kernel and the CUDA kernel do.
    """
    B, C, H, W = q.shape
    acc = torch.zeros((B, 3, H, W), dtype=torch.float32, device=q.device)
    for c in range(C):
        acc = acc + q[:, c, None] * weights[:, c, :, None, None]
    return _pack_u32(acc[:, 0], acc[:, 1], acc[:, 2])


def composite_packed(q, tables):
    """Table composite: q f32[B, C, H, W] quantized values, tables
    f32[B, C, 256, 3] -> i32[B, H, W] packed (additive, c in order)."""
    B, C, H, W = q.shape
    acc = torch.zeros((B, 3, H, W), dtype=torch.float32, device=q.device)
    idx = q.to(torch.int64).reshape(B, C, H * W)
    for c in range(C):
        rgb = torch.stack([
            torch.gather(tables[:, c, :, comp], 1, idx[:, c])
            for comp in range(3)], dim=1)              # [B, 3, H*W]
        acc = acc + rgb.reshape(B, 3, H, W)
    return _pack_u32(acc[:, 0], acc[:, 1], acc[:, 2])


def quantize_tiles(raw, window_start, window_end, family, coefficient,
                   reverse, cd_start, cd_end):
    """raw [B, C, H, W] + per-tile [B, C] settings -> f32[B, C, H, W]
    quantized, reversed and clipped to 0..255 (the value that indexes a
    table or scales a ramp weight)."""
    B, C, H, W = raw.shape
    q = quantize_float(raw.reshape(B * C, H, W),
                       window_start.reshape(B * C),
                       window_end.reshape(B * C),
                       family.reshape(B * C),
                       coefficient.reshape(B * C), cd_start, cd_end)
    # Reverse-intensity codomain op (ReverseIntensityContext,
    # ImageRegionRequestHandler.java:717-730): mirror within the codomain.
    q = torch.where(reverse.reshape(B * C)[:, None, None] != 0,
                    float(cd_start + cd_end) - q, q)
    return torch.clamp(q, 0.0, 255.0).reshape(B, C, H, W)


def render_tile_batch_packed_plain(raw, window_start, window_end, family,
                                   coefficient, reverse, cd_start, cd_end,
                                   tables):
    """Plain PyTorch render on any device: the CPU path, and the version
    the CUDA kernels are compared with.  Same contract as
    :func:`render_tile_batch_packed`."""
    q = quantize_tiles(raw, window_start, window_end, family, coefficient,
                       reverse, cd_start, cd_end)
    if tables.dim() == 3:
        return composite_ramp_packed(q, tables)
    return composite_packed(q, tables)


# ------------------------------------- the mesh step's composite (K12)

def composite_partial_plain(raw, window_start, window_end, family,
                            coefficient, reverse, cd_start, cd_end, tables,
                            c0: int = 0, c1=None):
    """Plain PyTorch K12a on any device: one chan shard's partial
    composite.  raw [B, C, H, W] with per-tile [B, C] settings and f32[B,
    C, 3] ramp weights or f32[B, C, 256, 3] tables -> f32[3, B, H, W], the
    sum over the channels ``[c0, c1)`` (default all) in channel order of
    each channel's weighted or looked-up contribution, each product and
    add rounded on its own.  The quantized value is
    :func:`quantize_tiles`' (``ops.quantum``, reversed, clipped to
    0..255), K1's.  The JAX package's ``_local_render_batched``."""
    B, C, H, W = raw.shape
    c1 = C if c1 is None else c1
    part = slice(c0, c1)
    q = quantize_tiles(raw[:, part], window_start[:, part],
                       window_end[:, part], family[:, part],
                       coefficient[:, part], reverse[:, part], cd_start,
                       cd_end)
    acc = torch.zeros((B, 3, H, W), dtype=torch.float32, device=raw.device)
    if tables.dim() == 3:
        for k, c in enumerate(range(c0, c1)):
            acc = acc + q[:, k, None] * tables[:, c, :, None, None]
    else:
        idx = q.to(torch.int64).reshape(B, c1 - c0, H * W)
        for k, c in enumerate(range(c0, c1)):
            rgb = torch.stack([
                torch.gather(tables[:, c, :, comp], 1, idx[:, k])
                for comp in range(3)], dim=1)          # [B, 3, H*W]
            acc = acc + rgb.reshape(B, 3, H, W)
    return acc.permute(1, 0, 2, 3).contiguous()


def composite_pack_plain(partials):
    """Plain PyTorch K12b: the all-gathered partials f32[S, 3, B, H, W]
    summed in shard order (s = 0, 1, ...), rounded half to even, clipped
    and packed -> i32[B, H, W] (the ``psum`` and pack of the JAX
    ``_composite_step_batched``)."""
    acc = partials[0]
    for s in range(1, partials.shape[0]):
        acc = acc + partials[s]
    return _pack_u32(acc[0], acc[1], acc[2])


def composite_partial(raw, window_start, window_end, family, coefficient,
                      reverse, cd_start, cd_end, tables, c0: int = 0,
                      c1=None):
    """K12a dispatcher: :func:`composite_partial_plain` for a CPU tensor,
    the kernel (``kernels.mesh.composite_partial``) for a CUDA tensor."""
    if raw.device.type == "cpu":
        return composite_partial_plain(raw, window_start, window_end,
                                       family, coefficient, reverse,
                                       cd_start, cd_end, tables, c0, c1)
    from ..kernels import mesh as kernels

    return kernels.composite_partial(raw, window_start, window_end, family,
                                     coefficient, reverse, cd_start, cd_end,
                                     tables, c0, c1)


def composite_pack(partials):
    """K12b dispatcher: :func:`composite_pack_plain` for a CPU tensor, the
    kernel (``kernels.mesh.composite_pack``) for a CUDA tensor."""
    if partials.device.type == "cpu":
        return composite_pack_plain(partials)
    from ..kernels import mesh as kernels

    return kernels.composite_pack(partials)


def render_tile_batch_packed(raw, window_start, window_end, family,
                             coefficient, reverse, cd_start, cd_end,
                             tables):
    """Batched render to packed ints, with per-tile settings.

    Args:
      raw:          [B, C, H, W] uint8 / uint16 / float32.
      window_start: f32[B, C]
      window_end:   f32[B, C]
      family:       i32[B, C] quantum family ids
      coefficient:  f32[B, C] family curve coefficients
      reverse:      i32[B, C] 1 to apply reverse-intensity, else 0
      cd_start:     int, codomain start (QuantumDef), shared by the batch
      cd_end:       int, codomain end
      tables:       f32[B, C, 3] ramp weights, or f32[B, C, 256, 3]
                    tables when a channel has a LUT.

    Returns:
      i32[B, H, W] on raw's device, holding u32 R|G<<8|B<<16|0xFF<<24.

    On a CUDA tensor this launches the ramp or LUT kernel (or raises); on
    a CPU tensor it runs :func:`render_tile_batch_packed_plain`.
    """
    if raw.device.type == "cpu":
        return render_tile_batch_packed_plain(
            raw, window_start, window_end, family, coefficient, reverse,
            cd_start, cd_end, tables)
    from ..kernels import render as kernels

    if tables.dim() == 3:
        return kernels.render_ramp(raw, window_start, window_end, family,
                                   coefficient, reverse, tables,
                                   cd_start, cd_end)
    return kernels.render_lut(raw, window_start, window_end, family,
                              coefficient, reverse, tables, cd_start,
                              cd_end)


def unpack_rgba(packed: np.ndarray) -> np.ndarray:
    """u32 (or i32) [..., H, W] packed pixels -> u8[..., H, W, 4] RGBA."""
    packed = np.ascontiguousarray(np.asarray(packed))
    le = packed.view(np.uint32).astype("<u4", copy=False)
    return le.view(np.uint8).reshape(packed.shape + (4,))


def batched_settings(settings: Dict[str, Union[torch.Tensor, int]],
                     batch: int = 1) -> tuple:
    """Splat tensor settings into :func:`render_tile_batch_packed`
    argument order after ``raw``, repeating per-channel settings across a
    batch of ``batch`` tiles."""
    def tile(t):
        return t[None].expand((batch,) + tuple(t.shape)).contiguous()

    return (
        tile(settings["window_start"]), tile(settings["window_end"]),
        tile(settings["family"]), tile(settings["coefficient"]),
        tile(settings["reverse"]), settings["cd_start"],
        settings["cd_end"],
        tile(settings["tables"]),
    )
