"""Request contexts: URL-parameter parsing, validation, cache keys.

Re-expression of ``ImageRegionCtx.java:122-402`` and ``ShapeMaskCtx.java``.
Contexts are plain dataclasses (JSON-serializable — the analogue of the
reference's Jackson round-trip over the event bus, which its tests lock
down; SURVEY.md section 4).

Cache keys intentionally reproduce the reference's exact byte format —
``<java class name>:k=v...`` hashed with Guava-seeded SipHash-2-4
(``ImageRegionCtx.java:165-177``) and ``ome.model.roi.Mask:<id>:<color>``
(``ShapeMaskCtx.java:35-36,77-81``) — so a deployment can share a warm
Redis cache with the Java service it replaces.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass
from typing import List, Mapping, Optional, Tuple

from ..models.rendering import Projection
from ..utils.siphash import guava_siphash24_hex
from .errors import BadRequestError
from .region import RegionDef

# Exact strings used by the reference for cache-key derivation.
_IMAGE_CTX_CLASS = "com.glencoesoftware.omero.ms.image.region.ImageRegionCtx"
_MASK_CLASS = "ome.model.roi.Mask"
_PIXELS_CLASS = "ome.model.core.Pixels"


def _require(params: Mapping[str, str], key: str) -> str:
    value = params.get(key)
    if value is None:
        raise BadRequestError(f"Missing parameter '{key}'")
    return value


def _parse_int(value: str, what: str = "parameter value") -> int:
    try:
        return int(value)
    except (TypeError, ValueError):
        raise BadRequestError(f"Incorrect format for {what} '{value}'")


@dataclass
class ImageRegionCtx:
    """Parsed ``render_image_region`` / ``render_image`` request."""

    image_id: int = 0
    z: int = 0
    t: int = 0
    tile: Optional[RegionDef] = None
    resolution: Optional[int] = None
    region: Optional[RegionDef] = None
    channels: Optional[List[int]] = None
    windows: Optional[List[Tuple[Optional[float], Optional[float]]]] = None
    colors: Optional[List[Optional[str]]] = None
    m: Optional[str] = None
    maps: Optional[List[dict]] = None
    compression_quality: Optional[float] = None
    projection: Optional[int] = None
    projection_start: Optional[int] = None
    projection_end: Optional[int] = None
    inverted_axis: Optional[bool] = None
    format: str = "jpeg"
    flip_horizontal: bool = False
    flip_vertical: bool = False
    cache_key: str = ""
    omero_session_key: Optional[str] = None

    # ------------------------------------------------------------- parsing

    @classmethod
    def from_params(cls, params: Mapping[str, str],
                    omero_session_key: Optional[str] = None
                    ) -> "ImageRegionCtx":
        ctx = cls(omero_session_key=omero_session_key)
        ctx.image_id = _parse_int(_require(params, "imageId"),
                                  "imageid parameter")
        ctx.z = _parse_int(_require(params, "theZ"))
        ctx.t = _parse_int(_require(params, "theT"))
        ctx._parse_tile(params.get("tile"))
        ctx._parse_region(params.get("region"))
        ctx._parse_channels(params.get("c"))
        ctx._parse_model(params.get("m"))
        q = params.get("q")
        if q is not None:
            try:
                ctx.compression_quality = float(q)
            except ValueError:
                raise BadRequestError(
                    f"Incorrect format for parameter value '{q}'")
        ia = params.get("ia")
        # The reference parses with Boolean.parseBoolean ("true"/"false");
        # webgateway sends 0/1, accepted here too.
        ctx.inverted_axis = (
            None if ia is None else ia.lower() in ("true", "1")
        )
        ctx._parse_projection(params.get("p"))
        maps = params.get("maps")
        if maps is not None:
            try:
                ctx.maps = json.loads(maps)
            except json.JSONDecodeError:
                raise BadRequestError(f"Malformed maps JSON '{maps}'")
        flip = (params.get("flip") or "").lower()
        ctx.flip_horizontal = "h" in flip
        ctx.flip_vertical = "v" in flip
        ctx.format = params.get("format") or "jpeg"
        ctx.cache_key = cls.create_cache_key(params)
        return ctx

    def _parse_tile(self, tile_string: Optional[str]) -> None:
        """``res,x,y[,w,h]`` (= getTileFromString, ``:232-245``)."""
        if tile_string is None:
            return
        parts = tile_string.split(",")
        try:
            self.tile = RegionDef(x=int(parts[1]), y=int(parts[2]))
            if len(parts) == 5:
                self.tile.width = int(parts[3])
                self.tile.height = int(parts[4])
            self.resolution = int(parts[0])
        except (ValueError, IndexError):
            raise BadRequestError(
                f"Improper tile string '{tile_string}'")

    def _parse_region(self, region_string: Optional[str]) -> None:
        """``x,y,w,h`` (= getRegionFromString, ``:252-273``)."""
        if region_string is None:
            return
        parts = region_string.split(",")
        if len(parts) != 4:
            raise BadRequestError(
                "Region string format incorrect. Should be 'x,y,w,h'")
        try:
            self.region = RegionDef(
                x=int(parts[0]), y=int(parts[1]),
                width=int(parts[2]), height=int(parts[3]),
            )
        except ValueError:
            raise BadRequestError(
                f"Improper number formatting in region string {region_string}")

    def _parse_channels(self, channel_info: Optional[str]) -> None:
        """``[-]i|min:max$RRGGBB,...`` (= getChannelInfoFromString,
        ``:281-326``; including its requirement that a ``|`` clause carries a
        ``$color`` — the reference NPEs into a 400 otherwise)."""
        if channel_info is None:
            return
        self.channels, self.windows, self.colors = [], [], []
        for chunk in channel_info.split(","):
            try:
                head, _, rest = chunk.partition("|")
                color = None
                window: Tuple[Optional[float], Optional[float]] = (None, None)
                if "$" in head:
                    head, _, color = head.partition("$")
                self.channels.append(int(head))
                if rest:
                    if "$" in rest:
                        window_str, _, color = rest.partition("$")
                    else:
                        # Reference behavior: window.split on a null window
                        raise ValueError("window clause without color")
                    lo, sep, hi = window_str.partition(":")
                    if sep:
                        window = (float(lo), float(hi))
                self.colors.append(color)
                self.windows.append(window)
            except ValueError:
                raise BadRequestError(f"Failed to parse channel '{chunk}'")

    def _parse_model(self, color_model: Optional[str]) -> None:
        """g -> greyscale, c -> rgb, else None (= ``:333-341``)."""
        if color_model == "g":
            self.m = "greyscale"
        elif color_model == "c":
            self.m = "rgb"
        else:
            self.m = None

    def _parse_projection(self, projection: Optional[str]) -> None:
        """``intmax|start:end`` etc. (= getProjectionFromString,
        ``:370-402``; malformed start/end silently ignored)."""
        if projection is None:
            return
        parts = projection.split("|")
        mode = {
            "intmax": int(Projection.MAXIMUM_INTENSITY),
            "intmean": int(Projection.MEAN_INTENSITY),
            "intsum": int(Projection.SUM_INTENSITY),
        }.get(parts[0])
        if mode is not None:
            self.projection = mode
        if len(parts) != 2:
            return
        lo, _, hi = parts[1].partition(":")
        # Malformed interval tolerated; a failure after start is parsed
        # leaves start set (matching the reference's single try block).
        try:
            self.projection_start = int(lo)
        except ValueError:
            return
        try:
            self.projection_end = int(hi)
        except ValueError:
            pass

    # ----------------------------------------------------------- cache key

    @staticmethod
    def create_cache_key(params: Mapping[str, str]) -> str:
        """SipHash-2-4 over the class name + sorted ``:k=v`` pairs
        (= createCacheKey, ``ImageRegionCtx.java:165-177``)."""
        pieces = [_IMAGE_CTX_CLASS]
        for key in sorted(set(params.keys())):
            pieces.append(f":{key}={params[key]}")
        return guava_siphash24_hex("".join(pieces))

    @staticmethod
    def pixels_metadata_cache_key(image_id: int) -> str:
        """The pixels-metadata cache key of an image
        (``ImageRegionRequestHandler.java:317-318``)."""
        return f"{_PIXELS_CLASS}:Image:{image_id}"

    def to_json(self) -> dict:
        """The ctx as the sidecar wire carries it (the JAX
        ``ImageRegionCtx.to_json``: the dataclass fields, tile and region
        as ``[x, y, w, h]``)."""
        d = asdict(self)
        d["tile"] = None if self.tile is None else self.tile.as_tuple()
        d["region"] = (None if self.region is None
                       else self.region.as_tuple())
        return d

    @classmethod
    def from_json(cls, d: dict) -> "ImageRegionCtx":
        d = dict(d)
        for key in ("tile", "region"):
            if d.get(key) is not None:
                d[key] = RegionDef(*d[key])
        if d.get("windows") is not None:
            d["windows"] = [tuple(w) for w in d["windows"]]
        return cls(**d)


@dataclass
class ShapeMaskCtx:
    """Parsed ``render_shape_mask`` request (= ShapeMaskCtx.java)."""

    shape_id: int = 0
    color: Optional[str] = None
    flip_horizontal: bool = False
    flip_vertical: bool = False
    omero_session_key: Optional[str] = None

    @classmethod
    def from_params(cls, params: Mapping[str, str],
                    omero_session_key: Optional[str] = None
                    ) -> "ShapeMaskCtx":
        ctx = cls(omero_session_key=omero_session_key)
        ctx.shape_id = _parse_int(_require(params, "shapeId"),
                                  "shapeId parameter")
        ctx.color = params.get("color")
        flip = (params.get("flip") or "").lower()
        ctx.flip_horizontal = "h" in flip
        ctx.flip_vertical = "v" in flip
        return ctx

    def cache_key(self) -> str:
        """``ome.model.roi.Mask:<id>:<color>`` (= CACHE_KEY_FORMAT,
        ``ShapeMaskCtx.java:35-36,77-81``), color ``null`` when unset as
        Java formats it."""
        color = "null" if self.color is None else self.color
        return f"{_MASK_CLASS}:{self.shape_id}:{color}"

    def to_json(self) -> dict:
        return asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "ShapeMaskCtx":
        return cls(**d)


def plane_route_key(ctx) -> str:
    """The request's source-plane identity (the JAX
    ``parallel.fleet.plane_route_key``): everything that pins which bytes
    are read, nothing the rendering settings touch, so every render of one
    plane (re-window, re-colour, format) has one key.  The raw cache
    records it at staging (``DeviceRawCache.resident_route``, the explain
    plane's "is this plane warm" probe)."""
    tile = ((ctx.tile.x, ctx.tile.y, ctx.tile.width, ctx.tile.height)
            if ctx.tile is not None else None)
    region = ((ctx.region.x, ctx.region.y, ctx.region.width,
               ctx.region.height) if ctx.region is not None else None)
    parts = (ctx.image_id, ctx.z, ctx.t, ctx.resolution, tile, region)
    return hashlib.blake2b(repr(parts).encode(),
                           digest_size=16).hexdigest()
