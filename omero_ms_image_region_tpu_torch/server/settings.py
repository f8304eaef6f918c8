"""Apply a parsed request context to rendering settings.

Re-expression of ``ImageRegionRequestHandler.updateSettings``
(``ImageRegionRequestHandler.java:689-741``): the request's channel list
toggles activity (1-based, sign = active), windows override the per-channel
quantization interval, colors select a LUT (``*.lut``) or an HTML RGBA
color, the ``maps`` JSON enables the reverse-intensity codomain op, and
``m`` selects the greyscale/rgb model.

Unlike the reference — which mutates a live Java ``Renderer`` — this
produces a plain :class:`RenderingDef`; the kernel consumes it via
``ops.render.pack_settings`` so that settings application stays a pure,
unit-testable host function.
"""

from __future__ import annotations

from ..models.rendering import RenderingDef, RenderingModel
from ..utils.color import split_html_color
from .ctx import ImageRegionCtx
from .errors import BadRequestError


def render_identity_key(ctx: ImageRegionCtx) -> str:
    """Canonical identity of a render for in-flight dedup: everything the
    bytes depend on (plane address, region, channels, windows, colours,
    maps, model, flips, format, quality) and nothing else.

    ``ctx.cache_key`` is exactly that: SipHash over the sorted request
    params, so params that differ only in order share one key.  The
    session key is not a param: ACL runs per caller before the shared
    render is awaited.
    """
    return ctx.cache_key


def update_settings(rdef: RenderingDef, ctx: ImageRegionCtx) -> RenderingDef:
    """Return a copy of ``rdef`` with the request's settings applied.

    Mirrors ``updateSettings`` (``ImageRegionRequestHandler.java:689-741``):

    * channel ``c`` is active iff ``c+1`` is in the request channel list
      (the list holds signed 1-based indices; negative = off);
    * windows / colors are read at the loop position (the reference's
      ``idx`` advances once per channel, active or not);
    * a color ending in ``.lut`` selects a lookup table, anything else is
      parsed as an HTML color (3/4/6/8 hex digits);
    * ``maps[c]["reverse"]["enabled"] == True`` adds the reverse-intensity
      codomain op for that channel;
    * ``m`` (already normalized to "greyscale"/"rgb" by the ctx parser)
      switches the model.
    """
    out = rdef.copy()
    channels = ctx.channels
    for c, cb in enumerate(out.channel_bindings):
        if channels is not None:
            cb.active = (c + 1) in channels
        if not cb.active:
            continue
        if ctx.windows is not None and c < len(ctx.windows):
            lo, hi = ctx.windows[c]
            if lo is not None and hi is not None:
                cb.input_start = float(lo)
                cb.input_end = float(hi)
        if ctx.colors is not None and c < len(ctx.colors):
            color = ctx.colors[c]
            if color is not None:
                if color.endswith(".lut"):
                    cb.lut = color
                else:
                    rgba = split_html_color(color)
                    if rgba is None:
                        raise BadRequestError(
                            f"Invalid color '{color}'")
                    cb.red, cb.green, cb.blue, cb.alpha = rgba
                    cb.lut = None
        if ctx.maps is not None and c < len(ctx.maps):
            m = ctx.maps[c]
            if isinstance(m, dict):
                reverse = m.get("reverse") or m.get("inverted")
                if isinstance(reverse, dict) and reverse.get("enabled") is True:
                    cb.reverse_intensity = True
    if ctx.m is not None:
        out.model = (RenderingModel.GREYSCALE if ctx.m == "greyscale"
                     else RenderingModel.RGB)
    return out
