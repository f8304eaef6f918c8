"""Conditional-HTTP semantics: content-addressed ETags, 304s and honest
``Cache-Control``/``Vary``.

A copy of the JAX package's ``server/httpcache.py`` (the port keeps its own
copy of every module it needs).  The ETag derives from the render identity
(``ImageRegionCtx.cache_key``: SipHash over the sorted params) and a
deployment epoch, never from the pixels, so:

* two requests whose params differ only in order share one ETag, and
  ``/7/0/0/`` and ``/7/0/0`` alias (the route's ``tail`` never reaches the
  params);
* an ``If-None-Match`` revalidation is answered 304 with no render, no
  admission slot and no single-flight entry, and a 304 reveals nothing the
  URL does not;
* bumping ``http-cache.epoch`` invalidates every edge-cached entry at once.

The tags, headers and dates are byte for byte the JAX package's: an edge
cache in front of either service holds entries the other revalidates.
Device-free.
"""

from __future__ import annotations

import hashlib
import os
import re
from email.utils import formatdate, parsedate_to_datetime
from typing import Optional, Tuple

# ETag schema version: bumping the derivation below MUST bump this
# prefix (a silently changed ETag invalidates every CDN edge at once;
# tests/test_torch_httpcache.py holds it to the JAX package's tags).
_SCHEMA = "ir1"

# Epochs ride inside the quoted ETag: token characters only, so a
# config typo can never smuggle a quote/comma into the header.
EPOCH_RE = re.compile(r"^[A-Za-z0-9._-]+$")

# ``http-cache.epoch: auto``: derive the epoch from the data tree's
# ingest/source stamps at startup instead of asking the operator to
# bump a string by hand (the explicit value stays the override).
EPOCH_AUTO = "auto"


def etag_for(cache_key: str, epoch: str = "0") -> str:
    """Strong ETag for a render identity under ``epoch``.

    ``cache_key`` is the ctx's canonical identity
    (``render_identity_key`` == ``ImageRegionCtx.cache_key``, or the
    mask ctx's ``cache_key()``).  The digest folds the epoch, and the
    epoch ALSO rides visibly in the tag so an operator can read which
    generation an edge holds straight off a response header."""
    digest = hashlib.blake2b(
        f"{epoch}:{cache_key}".encode(), digest_size=12).hexdigest()
    return f'"{_SCHEMA}-{epoch}-{digest}"'


def if_none_match_matches(header: Optional[str], etag: str) -> bool:
    """RFC 9110 ``If-None-Match`` evaluation against one strong ETag.

    ``*`` matches any current representation; otherwise the header is
    a comma-separated list of entity tags, compared WEAKLY (the
    ``W/`` prefix is stripped — weak comparison is what 304
    revalidation specifies, and our tags are strong anyway)."""
    if not header:
        return False
    header = header.strip()
    if header == "*":
        return True
    for candidate in header.split(","):
        candidate = candidate.strip()
        if candidate.startswith("W/"):
            candidate = candidate[2:]
        if candidate == etag:
            return True
    return False


def cache_headers(max_age_s: int, acl_gated: bool,
                  session_cookie: str = "Cookie"
                  ) -> Tuple[str, Optional[str]]:
    """(Cache-Control, Vary-or-None) for a cacheable 200/304.

    Honesty rules (deploy/DEPLOY.md "Edge caching"):

    * ``max_age_s == 0`` → ``no-cache`` — edges may STORE but must
      revalidate every serve; with free 304s that is the safe default
      posture (every repeat view costs one conditional round-trip,
      never a render).
    * ACL-gated images are ``private`` and vary on the session-bearing
      header, so a shared cache can never serve one session's entry to
      another; public images are ``public`` with NO Vary (the
      cookie-blind entry is safe for everyone, and varying would
      shatter the edge's hit rate per-user for no protection).
    """
    scope = "private" if acl_gated else "public"
    if max_age_s <= 0:
        cc = f"{scope}, no-cache"
    else:
        cc = f"{scope}, max-age={int(max_age_s)}"
    vary = session_cookie if acl_gated else None
    return cc, vary


# ------------------------------------------------------- epoch: auto

def derive_epoch(data_dir: str) -> str:
    """Derive the cache epoch from the data tree's source mtimes.

    The stamp is the NEWEST mtime among each image directory's
    metadata files (meta.json / NGFF .zattrs / a TIFF) plus the image
    directories themselves — exactly the files an ingest touches, so
    re-ingesting any image bumps the deployment epoch and every
    edge-cached entry revalidates fresh.  Deterministic for a given
    tree (pinned in the golden ETag corpus): ``m<seconds>`` with the
    mtime truncated to whole seconds (sub-second noise across
    filesystems must not split a fleet's epochs).

    Shallow on purpose: one listdir of ``data_dir`` + a few stats per
    image — never a recursive walk over chunk stores.  A missing or
    empty tree derives "0" (the default epoch)."""
    newest = 0
    try:
        entries = sorted(os.scandir(data_dir), key=lambda e: e.name)
    except OSError:
        return "0"
    for entry in entries:
        try:
            if not entry.is_dir():
                continue
            newest = max(newest, int(entry.stat().st_mtime))
            for name in ("meta.json", ".zattrs"):
                p = os.path.join(entry.path, name)
                try:
                    newest = max(newest, int(os.stat(p).st_mtime))
                except OSError:
                    pass
            with os.scandir(entry.path) as inner:
                for child in inner:
                    if child.name.endswith((".tif", ".tiff",
                                            ".ome.tif")):
                        newest = max(newest,
                                     int(child.stat().st_mtime))
                    elif child.is_dir():
                        # NGFF group root one level down (the ingest
                        # layout): its .zattrs is the geometry stamp.
                        p = os.path.join(child.path, ".zattrs")
                        try:
                            newest = max(newest,
                                         int(os.stat(p).st_mtime))
                        except OSError:
                            pass
        except OSError:
            continue
    return f"m{newest}" if newest else "0"


# ---------------------------------------------------- Last-Modified

def last_modified_basis(mtime: Optional[float],
                        epoch: str) -> Optional[float]:
    """The instant the stored representation last changed, for
    Last-Modified / If-Modified-Since purposes — the source mtime
    FOLDED with the cache epoch, so bumping the epoch invalidates
    IMS-only clients exactly like it invalidates ETags:

    * default epoch ``"0"``: the source mtime alone;
    * derived ``m<seconds>`` epochs carry their own instant: the
      basis is ``max(mtime, epoch_seconds)`` — an epoch bump moves
      Last-Modified forward, so every stored IMS date goes stale;
    * any OTHER operator epoch is un-ordered in time: None — the
      Last-Modified header is withheld and the IMS-only 304 leg
      disarms (the ETag keeps revalidation free; a 304 judged
      against a pre-bump Last-Modified would revive exactly the
      stale entries the bump was meant to kill)."""
    if mtime is None:
        return None
    if epoch == "0":
        return mtime
    if epoch.startswith("m") and epoch[1:].isdigit():
        return max(float(mtime), float(epoch[1:]))
    return None

def http_date(ts: float) -> str:
    """Unix seconds -> RFC 9110 HTTP-date (IMF-fixdate, GMT)."""
    return formatdate(ts, usegmt=True)


def parse_http_date(value: Optional[str]) -> Optional[float]:
    """HTTP-date header -> unix seconds (None on garbage — a client
    sending a malformed If-Modified-Since just gets the full 200)."""
    if not value:
        return None
    try:
        return parsedate_to_datetime(value).timestamp()
    except (TypeError, ValueError, OverflowError):
        return None


def not_modified_since(ims_header: Optional[str],
                       mtime: Optional[float]) -> bool:
    """RFC 9110 If-Modified-Since evaluation against the source
    mtime.  True = the stored response is still fresh (304).  The
    comparison truncates to whole seconds — HTTP-dates carry no
    sub-second precision, and a sub-second ingest would otherwise
    304 forever under an equal-seconds stamp."""
    if mtime is None:
        return False
    since = parse_http_date(ims_header)
    if since is None:
        return False
    return int(mtime) <= int(since)
