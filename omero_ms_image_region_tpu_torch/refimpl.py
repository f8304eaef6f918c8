"""Faithful CPU (numpy) implementation of the renderer semantics.

A copy of the JAX package's ``refimpl.py`` (the stand-in for the
reference's Java ``omeis.providers.re.Renderer``).  The port renders on
the host with it in one place only: a frontend's degraded mode
(``server.degraded``), which must give the bytes the JAX frontend's
degraded mode gives.

It shares no code with ``ops/``: quantization is computed value-wise (no
table folding), colour, LUT and model application is branch-per-channel,
composition an explicit accumulate, mirroring the structure of the Java
pipeline (quantize -> codomain chain -> color -> composite;
``ImageRegionRequestHandler.java:559`` and ``updateSettings``
``:689-741``).
"""

from __future__ import annotations

import numpy as np

from .models.rendering import Family, RenderingDef, RenderingModel, Projection


def _family_transform(x: np.ndarray, family: Family, k: float) -> np.ndarray:
    if family == Family.LINEAR:
        return x
    if family == Family.POLYNOMIAL:
        return np.sign(x) * np.power(np.abs(x), k)
    if family == Family.LOGARITHMIC:
        return np.log(np.maximum(x, 1.0))
    if family == Family.EXPONENTIAL:
        # Unreachable from quantize_ref, which evaluates the exponential
        # family in shifted form to avoid overflow; see its branch below.
        raise ValueError("exponential family is handled in quantize_ref")
    raise ValueError(family)


def quantize_ref(values: np.ndarray, window_start: float, window_end: float,
                 family: Family = Family.LINEAR, coefficient: float = 1.0,
                 cd_start: int = 0, cd_end: int = 255) -> np.ndarray:
    """Value-wise quantization (= QuantumStrategy for one channel)."""
    def _spow(v, k):
        return np.sign(v) * np.power(np.abs(v), k)

    x = np.clip(values.astype(np.float64),
                min(window_start, window_end),
                max(window_start, window_end))
    step = (values.astype(np.float64) >= window_end).astype(np.float64)
    if family == Family.EXPONENTIAL:
        k = coefficient
        pe = _spow(np.float64(window_end), k)
        es = np.exp(np.minimum(_spow(np.float64(window_start), k) - pe, 0.0))
        ex = np.exp(np.minimum(_spow(x, k) - pe, 0.0))
        den = 1.0 - es
        ratio = step if abs(den) < 1e-12 else (ex - es) / den
    else:
        fs = _family_transform(np.float64(window_start), family, coefficient)
        fe = _family_transform(np.float64(window_end), family, coefficient)
        fx = _family_transform(x, family, coefficient)
        den = fe - fs
        # Window degenerate under the family transform (ws == we, or e.g.
        # log over [0, 1]): all-or-nothing step on the raw value.
        ratio = step if abs(den) < 1e-12 else (fx - fs) / den
    ratio = np.clip(ratio, 0.0, 1.0)
    return np.round(cd_start + (cd_end - cd_start) * ratio).astype(np.int32)


def render_ref(raw: np.ndarray, rdef: RenderingDef,
               lut_provider=None) -> np.ndarray:
    """Render a raw [C, H, W] tile to u8[H, W, 4] RGBA.

    Follows the Java pipeline shape: per active channel quantize, apply the
    codomain chain, map through LUT or RGBA color, then composite.
    """
    C, H, W = raw.shape
    accum = np.zeros((H, W, 3), dtype=np.float64)
    greyscale = rdef.model == RenderingModel.GREYSCALE

    for c in range(C):
        cb = rdef.channel_bindings[c]
        if not cb.active:
            continue
        q = quantize_ref(
            raw[c], cb.input_start, cb.input_end, cb.family, cb.coefficient,
            rdef.quantum.cd_start, rdef.quantum.cd_end,
        )
        if cb.reverse_intensity:
            q = rdef.quantum.cd_end - q + rdef.quantum.cd_start
        if greyscale:
            # GreyScaleStrategy: first active channel only, value as grey.
            accum[..., 0] = q
            accum[..., 1] = q
            accum[..., 2] = q
            break
        lut_table = None
        if cb.lut is not None and lut_provider is not None:
            lut_table = lut_provider.get(cb.lut)
        if lut_table is not None:
            rgb = lut_table[q].astype(np.float64)
        else:
            color = np.array([cb.red, cb.green, cb.blue], dtype=np.float64)
            rgb = (q[..., None] / 255.0) * color
        accum += rgb * (cb.alpha / 255.0)

    rgb8 = np.clip(np.round(accum), 0, 255).astype(np.uint8)
    alpha = np.full((H, W, 1), 255, dtype=np.uint8)
    return np.concatenate([rgb8, alpha], axis=-1)


def flip_ref(src: np.ndarray, flip_horizontal: bool,
             flip_vertical: bool) -> np.ndarray:
    """Index-for-index port of the reference flip loop semantics
    (``ImageRegionRequestHandler.java:629-641``), used to prove the device
    flip matches."""
    if not flip_horizontal and not flip_vertical:
        return src
    if src is None:
        raise ValueError("Attempted to flip null image")
    H, W = src.shape[:2]
    if H == 0 or W == 0:
        raise ValueError("Attempted to flip image with 0 size")
    out = src.copy()
    y_idx = np.arange(H)
    x_idx = np.arange(W)
    dy = np.abs((H - y_idx - 1)) if flip_vertical else y_idx
    dx = np.abs((W - x_idx - 1)) if flip_horizontal else x_idx
    out[dy[:, None], dx[None, :]] = src
    return out


def project_ref(stack: np.ndarray, algorithm: Projection, start: int,
                end: int, stepping: int = 1,
                type_max: float = 255.0) -> np.ndarray:
    """Scalar-faithful projection (= ProjectionService loops, with the
    reference's inclusive-max / exclusive-mean-sum ranges and clamps)."""
    algorithm = Projection(algorithm)
    x = stack.astype(np.float64)
    if algorithm == Projection.MAXIMUM_INTENSITY:
        zs = range(start, end + 1, stepping)
        planes = [x[z] for z in zs]
        out = np.zeros_like(x[0])
        for p in planes:
            out = np.maximum(out, p)
        return out
    zs = list(range(start, end, stepping))
    out = np.zeros_like(x[0])
    for z in zs:
        out = out + x[z]
    if algorithm == Projection.MEAN_INTENSITY and zs:
        out = out / len(zs)
    return np.minimum(out, type_max)
