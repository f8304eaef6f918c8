"""Window + family quantization to the 8-bit codomain, in plain PyTorch.

Twin of the JAX package's ``ops/quantum.py`` (the reconstruction of
``omeis.providers.re.quantum.QuantumFactory`` / ``QuantumStrategy``;
``ImageRegionRequestHandler.java:259,273-276,433`` builds an 8-bit quantum
over [cdStart, cdEnd] = [0, 255]; ``ImageRegionVerticle.java:72-76``
enumerates the four families).

The mapping, for a pixel value ``v``, window ``[ws, we]``, family transform
``F`` with curve coefficient ``k``:

    q(v) = round(cd_start + (cd_end - cd_start) *
                 (F(clamp(v, ws, we)) - F(ws)) / (F(we) - F(ws)))

with family transforms:

    linear       F(x) = x
    polynomial   F(x) = sign(x) * |x|**k
    logarithmic  F(x) = log(max(x, 1))
    exponential  F(x) = exp(x**k)  (evaluated in the shifted form
                                    exp(F - F(we)) so float32 never overflows)

``round`` is half-to-even, as ``jnp.round`` and the CUDA kernels'
``rintf``.  This module is the plain version that the CPU path runs and
that the CUDA render kernels (``kernels/csrc/render.cu``) are held against.
"""

from __future__ import annotations

import torch

FAMILY_LINEAR = 0
FAMILY_POLYNOMIAL = 1
FAMILY_LOGARITHMIC = 2
FAMILY_EXPONENTIAL = 3

_EPS = 1e-12


def _signed_pow(x, k):
    return torch.sign(x) * torch.pow(torch.abs(x), k)


def _safe_log(x):
    return torch.log(torch.clamp_min(x, 1.0))


def _safe_den(den):
    return torch.where(torch.abs(den) < _EPS, torch.ones_like(den), den)


def _ratio(x, x_raw, ws, we, family, k):
    """Normalized position of x in the window under the family curve.

    ``x`` is already clamped to [ws, we]; ``x_raw`` is the unclamped value
    (needed for the degenerate ws == we step function).  ws/we/family/k
    broadcast against x.
    """
    den_lin = we - ws
    r_lin = (x - ws) / _safe_den(den_lin)

    ps, pe, px = _signed_pow(ws, k), _signed_pow(we, k), _signed_pow(x, k)
    den_poly = pe - ps
    r_poly = (px - ps) / _safe_den(den_poly)

    ls, le, lx = _safe_log(ws), _safe_log(we), _safe_log(x)
    den_log = le - ls
    r_log = (lx - ls) / _safe_den(den_log)

    # exponential, shifted by F(we) so every exponent is <= 0
    es = torch.exp(torch.clamp_max(ps - pe, 0.0))
    ex = torch.exp(torch.clamp_max(px - pe, 0.0))
    den_exp = 1.0 - es
    r_exp = (ex - es) / _safe_den(den_exp)

    def select(lin, poly, log, exp):
        return torch.where(
            family == FAMILY_LINEAR, lin,
            torch.where(family == FAMILY_POLYNOMIAL, poly,
                        torch.where(family == FAMILY_LOGARITHMIC, log, exp)))

    r = select(r_lin, r_poly, r_log, r_exp)
    # A window degenerate under the selected family transform (ws == we, or
    # both endpoints collapsing under F, e.g. log over [0, 1]) becomes an
    # all-or-nothing step on the unclamped value.
    degenerate = torch.abs(select(den_lin, den_poly, den_log, den_exp)) < _EPS
    r_deg = (x_raw >= we).to(torch.float32)
    return torch.where(degenerate, r_deg, r)


def to_float32(raw: torch.Tensor) -> torch.Tensor:
    """Raw pixels as f32.  uint16 widens through int32 first: its direct
    conversion is not implemented on every device."""
    if raw.dtype == torch.uint16:
        raw = raw.view(torch.int16).to(torch.int32) & 0xFFFF
    return raw.to(torch.float32)


def quantize_float(raw, window_start, window_end, family, coefficient,
                   cd_start=0, cd_end=255):
    """Quantized values as f32 (integral), any leading dims.

    ``raw`` is [N, H, W]; the settings are [N] (one entry per plane).
    """
    ws = window_start.to(torch.float32)[:, None, None]
    we = window_end.to(torch.float32)[:, None, None]
    fam = family[:, None, None]
    k = coefficient.to(torch.float32)[:, None, None]

    x_raw = to_float32(raw)
    x = torch.minimum(torch.maximum(x_raw, torch.minimum(ws, we)),
                      torch.maximum(ws, we))
    r = torch.clamp(_ratio(x, x_raw, ws, we, fam, k), 0.0, 1.0)
    return torch.round(float(cd_start) + float(cd_end - cd_start) * r)


def quantize(raw, window_start, window_end, family, coefficient,
             cd_start=0, cd_end=255):
    """Quantize raw channel planes into the 8-bit codomain.

    Args:
      raw:           [C, H, W] raw pixel values (u8 / u16 / f32 / ...).
      window_start:  f32[C] per-channel window start.
      window_end:    f32[C] per-channel window end.
      family:        i32[C] family id (FAMILY_* above).
      coefficient:   f32[C] family curve coefficient.
      cd_start/end:  codomain interval (QuantumDef; default [0, 255]).

    Returns:
      i32[C, H, W] quantized values in [cd_start, cd_end].
    """
    return quantize_float(raw, window_start, window_end, family,
                          coefficient, cd_start, cd_end).to(torch.int32)
