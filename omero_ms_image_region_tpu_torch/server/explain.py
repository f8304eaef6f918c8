"""The dry-run explain plane: ``GET /debug/explain?path=<render URL>``.

Counterpart of the JAX package's ``server/explain.py``.  It resolves what
the serving stack would decide for a render URL (the render identity, the
ETag, the plane's routing identity, the byte-cache and raw-cache
residency, the live admission and pressure posture, the image's pyramid
job) without rendering, staging or charging anything: one curl answers
"is this tile warm, and why was it slow".  It covers the image routes, the
mask, overlay and animation routes.

The ``federation`` section (JAX ``:347-371``) says which manifest this
host routes (epoch, digest, host), a pending newer epoch, and, with the
app's coordinator, the peers' agreement and the forked ones.  The JAX
document's other fleet sections (``ring``, ``members`` and the per-member
residency over the ``explain`` op) are absent.
"""

from __future__ import annotations

import asyncio
import json
import re
from typing import Dict, Optional
from urllib.parse import parse_qsl, urlsplit

from . import httpcache
from . import pressure as pressure_mod
from .ctx import ImageRegionCtx, ShapeMaskCtx, plane_route_key
from .errors import BadRequestError

# The served render routes (``server.app`` registers the same shapes); a
# trailing tail aliases as the router's ``{tail:.*}`` does.
_ROUTE_RE = re.compile(
    r"^/(?:webgateway|webclient)/"
    r"(?:render_image_region|render_image)/"
    r"(?P<imageId>\d+)/(?P<theZ>\d+)/(?P<theT>\d+)(?:/.*)?$")
_MASK_ROUTE_RE = re.compile(
    r"^/webgateway/render_shape_mask/(?P<shapeId>\d+)(?:/.*)?$")
_OVERLAY_ROUTE_RE = re.compile(
    r"^/webgateway/render_overlay/"
    r"(?P<imageId>\d+)/(?P<theZ>\d+)/(?P<theT>\d+)(?:/.*)?$")
_ANIMATION_ROUTE_RE = re.compile(
    r"^/webgateway/render_animation/"
    r"(?P<imageId>\d+)/(?P<theZ>\d+)/(?P<theT>\d+)(?:/.*)?$")


def _params(split, m) -> Dict[str, str]:
    params = dict(parse_qsl(split.query, keep_blank_values=True))
    params.pop("tail", None)
    params.update(m.groupdict())
    return params


def parse_render_path(path: str) -> Dict[str, str]:
    """An image render URL (path and query) -> the params the route
    handler would build (the tail dropped).  ``BadRequestError`` for
    anything that is not an image render route."""
    if not path or not path.startswith("/"):
        raise BadRequestError(
            "path must be a server-relative render URL")
    split = urlsplit(path)
    m = _ROUTE_RE.match(split.path)
    if m is None:
        raise BadRequestError(
            f"not a render route: {split.path!r} (expected "
            f"/webgateway|webclient/render_image[_region]/"
            f"<id>/<z>/<t>)")
    return _params(split, m)


def classify_render_path(path: str):
    """``(kind, params)`` of any served render route: ``image``, ``mask``,
    ``overlay`` or ``animation``."""
    if not path or not path.startswith("/"):
        raise BadRequestError(
            "path must be a server-relative render URL")
    split = urlsplit(path)
    for kind, rx in (("image", _ROUTE_RE),
                     ("mask", _MASK_ROUTE_RE),
                     ("overlay", _OVERLAY_ROUTE_RE),
                     ("animation", _ANIMATION_ROUTE_RE)):
        m = rx.match(split.path)
        if m is not None:
            return kind, _params(split, m)
    raise BadRequestError(
        f"not a render route: {split.path!r} (expected render_image"
        f"[_region], render_shape_mask, render_overlay or "
        f"render_animation)")


async def residency_doc(stack, raw_cache, key: str, route: str) -> dict:
    """The dry-run residency report: a byte-tier probe that neither
    back-fills nor bumps the LRU, and the raw cache's residency by the
    plane's routing identity."""
    byte_tier = None
    if stack is not None and key and getattr(stack, "enabled", True):
        from ..services.cache import probe_with_tier
        byte_tier = await probe_with_tier(stack, key)
    hbm = bool(raw_cache is not None and route
               and raw_cache.resident_route(route))
    return {"byte": byte_tier is not None,
            "byte_tier": byte_tier, "hbm": hbm,
            "planes": len(raw_cache) if raw_cache is not None else 0}


def _pyramid_job_doc(jobs, services, image_id: int) -> Optional[dict]:
    """The image's pyramid build (queued, running, deferred or done, its
    levels), from memory or the job's file; None without one."""
    if jobs is None:
        return None
    pixels = (getattr(services, "pixels_service", None)
              if services is not None
              else getattr(jobs, "pixels_service", None))
    if pixels is None:
        return None
    try:
        return jobs.job_for_source(pixels.image_dir(image_id))
    except Exception:
        return None


def _etag_fields(doc: dict, config, identity: str) -> None:
    hc = config.http_cache
    if hc.enabled:
        doc["etag"] = httpcache.etag_for(identity, hc.epoch)
        doc["epoch"] = hc.epoch


def _explain_mask(path, params, config) -> dict:
    """The mask route: its byte-cache key, its ETag identity (flips
    folded), its QoS class and whether the mask lane serves it."""
    mctx = ShapeMaskCtx.from_params(params, None)
    identity = (f"{mctx.cache_key()}:f{int(mctx.flip_horizontal)}"
                f"{int(mctx.flip_vertical)}")
    doc: dict = {
        "path": path,
        "kind": "mask",
        "identity": identity,
        "byte_cache_key": mctx.cache_key(),
        "qos": "interactive",
        "device_batched": bool(config.workloads.device_masks),
        "dry_run": True,
    }
    _etag_fields(doc, config, identity)
    return doc


def _explain_overlay(path, params, config, services, jobs) -> dict:
    """The overlay route: the app's identity (base key, shapes, colour)
    and the base plane's routing identity."""
    shapes_raw = params.pop("shapes", "")
    color = params.pop("color", None)
    params["format"] = "png"
    try:
        shape_ids = [int(s) for s in shapes_raw.split(",") if s]
    except ValueError:
        raise BadRequestError(
            f"Incorrect format for shapes '{shapes_raw}'")
    ctx = ImageRegionCtx.from_params(params, None)
    identity = (f"{ctx.cache_key}:ov:"
                + ",".join(str(s) for s in shape_ids)
                + f":{color or ''}")
    doc: dict = {
        "path": path,
        "kind": "overlay",
        "identity": identity,
        "base_identity": ctx.cache_key,
        "shapes": shape_ids,
        "plane_route_key": plane_route_key(ctx),
        "qos": "interactive",
        "dry_run": True,
    }
    _etag_fields(doc, config, identity)
    job_doc = _pyramid_job_doc(jobs, services, ctx.image_id)
    if job_doc is not None:
        doc["pyramid_job"] = job_doc
    return doc


def _explain_animation(path, params, config, services, jobs) -> dict:
    """The animation route: each frame's identity and plane routing
    identity (a frame is the plain tile route's request)."""
    axis = (params.pop("axis", "t") or "t").lower()
    if axis not in ("z", "t"):
        raise BadRequestError(f"Incorrect format for axis '{axis}'")
    frames_raw = params.pop("frames", "2")
    try:
        n_frames = int(frames_raw)
    except ValueError:
        raise BadRequestError(
            f"Incorrect format for frames '{frames_raw}'")
    cap = config.workloads.animation_max_frames
    if not 1 <= n_frames <= cap:
        raise BadRequestError(f"frames must be in [1, {cap}]")
    axis_key = "theZ" if axis == "z" else "theT"
    start = int(params.get(axis_key) or 0)
    identities, route_keys = [], []
    image_id = None
    for i in range(n_frames):
        fctx = ImageRegionCtx.from_params(
            dict(params, **{axis_key: str(start + i)}), None)
        image_id = fctx.image_id
        identities.append(fctx.cache_key)
        route_keys.append(plane_route_key(fctx))
    doc: dict = {
        "path": path,
        "kind": "animation",
        "axis": axis,
        "frames": n_frames,
        "identities": identities,
        "plane_route_keys": route_keys,
        "qos": "interactive",
        "streamed": True,
        "dry_run": True,
    }
    hc = config.http_cache
    if hc.enabled:
        doc["frame_etags"] = [httpcache.etag_for(k, hc.epoch)
                              for k in identities]
        doc["epoch"] = hc.epoch
    job_doc = _pyramid_job_doc(jobs, services, image_id)
    if job_doc is not None:
        doc["pyramid_job"] = job_doc
    return doc


def _federation_fields(doc: dict, federation_coord) -> None:
    """The federation's posture: the manifest this host routes, a pending
    newer epoch and the peers' agreement (the forked ones are ``stale`` or
    ``split-brain``)."""
    from ..parallel import federation
    manifest = federation.current()
    if manifest is None:
        return
    fed: dict = {"epoch": manifest.version, "digest": manifest.digest(),
                 "self_host": federation.self_host() or None}
    pend = federation.pending()
    if pend is not None:
        fed["pending_epoch"] = pend.version
        fed["pending_digest"] = pend.digest()
    agreement = dict(getattr(federation_coord, "agreement", None) or {})
    if agreement:
        fed["agreement"] = agreement
        fed["forked"] = sorted(n for n, v in agreement.items()
                               if v in ("stale", "split-brain"))
    doc["federation"] = fed


async def explain(path: str, config, services=None, admission=None,
                  jobs=None, proxy_client=None,
                  federation_coord=None) -> dict:
    """The explain document of one render URL.  Read-only: cache probes
    only, no renderer span moves.  A frontend (``proxy_client``, its
    ``server.sidecar.SidecarClient``) asks its sidecar for the residency
    over the ``explain`` op."""
    kind, params = classify_render_path(path)
    if kind == "mask":
        return _explain_mask(path, params, config)
    if kind == "overlay":
        return _explain_overlay(path, params, config, services, jobs)
    if kind == "animation":
        return _explain_animation(path, params, config, services, jobs)
    ctx = ImageRegionCtx.from_params(params, None)
    route_key = plane_route_key(ctx)
    doc: dict = {
        "path": path,
        "kind": "image",
        "identity": ctx.cache_key,
        "plane_route_key": route_key,
        "qos": "bulk" if pressure_mod.is_bulk(ctx) else "interactive",
        "dry_run": True,
    }
    job_doc = _pyramid_job_doc(jobs, services, ctx.image_id)
    if job_doc is not None:
        doc["pyramid_job"] = job_doc
    _etag_fields(doc, config, ctx.cache_key)
    _federation_fields(doc, federation_coord)
    if services is not None:
        doc["residency"] = await residency_doc(
            getattr(getattr(services, "caches", None), "image_region",
                    None),
            getattr(services, "raw_cache", None), ctx.cache_key, route_key)
    elif proxy_client is not None:
        try:
            status, body = await asyncio.wait_for(
                proxy_client.call("explain", {},
                                  extra={"key": ctx.cache_key,
                                         "route": route_key}), 2.0)
            doc["residency"] = (dict(json.loads(bytes(body).decode()))
                                if status == 200 and body
                                else {"error": f"status {status}"})
        except Exception as e:
            doc["residency"] = {"error": str(e)[:120]}
    if admission is not None:
        adm = {
            "inflight": admission.inflight,
            "max_queue": admission.max_queue,
            "effective_max_queue": admission.effective_max_queue(),
            "estimated_wait_ms": round(admission.estimated_wait_ms(), 1),
        }
        buckets = admission.session_buckets
        if buckets is not None:
            adm["session_buckets"] = {
                "tracked": len(buckets),
                "taken_total": buckets.taken_total,
                "refused_total": buckets.refused_total,
                "bulk_cost": buckets.bulk_cost,
            }
        doc["admission"] = adm
    governor = pressure_mod.active()
    if governor is not None:
        doc["pressure"] = {"summary": governor.summary(),
                           "engaged": governor.engaged_steps()}
    return doc
