"""Response provenance: where each response's bytes came from.

Counterpart of the JAX package's ``utils/provenance.py``, the one
vocabulary for that answer:

* a **provenance record** is a small dict assembled per finished request
  from marks the serving layers left on the request ctx (:func:`mark`):
  the byte-source tier (``304`` in the front, ``byte_cache`` in the
  handler's image-region and shape-mask probes, ``hbm_warm`` or
  ``render_cold`` from the raw cache's hit or miss), the ``coalesced``
  flag of a single-flight follower, the serving member, the QoS class and
  the session tokens the fairness gate charged;
* the record lands on the JSON access line (``prov``), feeds the
  ``imageregion_provenance_*`` counters (``utils.telemetry``; closed label
  sets: :data:`TIERS` and :data:`FLAGS` are the whole vocabulary), and is
  echoed as the ``X-Image-Region-Provenance`` header under
  ``telemetry.provenance-header`` (never on errors).

The port has one member (``-``), no pressure ladder and no sidecar: the
``peer``, ``disk`` and ``degraded`` tiers and the ``stolen``,
``failed_over``, ``drain_rehomed`` and ``quality_capped`` flags stay in
the vocabulary (the metric label sets the JAX package's budget names) but
are never marked; the record's ``ladder`` field comes with the pressure
governor and the sidecar's ``merge_wire`` with the sidecar.  Device-free
on import.
"""

from __future__ import annotations

from typing import Dict, Optional

# The byte-source tiers, cheapest first.  Closed: these seven strings are
# the whole ``tier`` label vocabulary on /metrics.
TIERS = ("304", "byte_cache", "peer", "disk", "hbm_warm",
         "render_cold", "degraded")

# Routing and serving flags a request may carry (each 0/1); closed, the
# ``flag`` label vocabulary.
FLAGS = ("stolen", "failed_over", "drain_rehomed", "coalesced",
         "quality_capped")

_ATTR = "_provenance"


def mark(ctx, **fields) -> None:
    """Merge provenance fields onto the request ctx (a dict made on the
    first mark); later marks win."""
    prov = getattr(ctx, _ATTR, None)
    if prov is None:
        prov = {}
        setattr(ctx, _ATTR, prov)
    prov.update(fields)


def marks(ctx) -> Dict:
    """The ctx's marks ({} when none)."""
    return getattr(ctx, _ATTR, None) or {}


def is_bulk(ctx) -> bool:
    """The JAX ``server.pressure.is_bulk`` QoS class: z-projections and
    full-plane (no tile, no region) renders are bulk; masks (a
    ``shape_id``) and tiles are interactive."""
    if getattr(ctx, "shape_id", None) is not None:
        return False
    return ctx.projection is not None or (
        ctx.tile is None and ctx.region is None)


def assemble(ctx, status: int, trace_id: Optional[str] = None) -> Dict:
    """The finished request's provenance record, from the ctx marks and
    the status: the tier defaults to ``render_cold`` (no cheaper layer
    claimed the request), and a 304 overrides every mark."""
    m = marks(ctx)
    if status == 304:
        tier = "304"
    else:
        tier = m.get("tier") or "render_cold"
        if tier not in TIERS:
            tier = "render_cold"
    record: Dict = {"tier": tier, "member": m.get("member") or "-"}
    for flag in FLAGS:
        if m.get(flag):
            record[flag] = 1
    try:
        bulk = is_bulk(ctx)
    except AttributeError:             # a ctx without tile or projection
        bulk = False
    record["qos"] = "bulk" if bulk else "interactive"
    tokens = m.get("tokens")
    if tokens:
        record["tokens"] = round(float(tokens), 3)
    if trace_id:
        record["trace"] = trace_id
    return record


def header_value(record: Dict) -> str:
    """The compact ``k=v; k=v`` form of the debug header."""
    parts = []
    for key in ("tier", "member", "qos", "tokens", "trace"):
        value = record.get(key)
        if value not in (None, "", "-"):
            parts.append(f"{key}={value}")
    flags = [f for f in FLAGS if record.get(f)]
    if flags:
        parts.append("flags=" + ",".join(flags))
    return "; ".join(parts)
