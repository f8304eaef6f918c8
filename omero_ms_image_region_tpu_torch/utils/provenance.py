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

The record also names the engaged prefix of the pressure governor's
ladder (``ladder``) and the ``quality_capped`` flag of a tile whose JPEG
quality ``drop_quality`` capped.  A frontend merges the marks its
sidecar made (:func:`merge_wire`, the reply's ``prov``) and marks
``degraded`` when its CPU fallback served (``server.degraded``).  With a
fleet (``parallel.fleet``) the router marks the serving ``member`` and the
``stolen``, ``failed_over`` and ``drain_rehomed`` flags, and a peer byte
fetch the ``peer`` tier; without one the member is ``-``.  The ``disk``
tier stays in the vocabulary (the metric label sets the JAX package's
budget names) but is never marked.  Device-free on import.
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


def merge_wire(ctx, wire_prov) -> None:
    """Add the marks a sidecar sent back (``prov`` on its reply) to the
    frontend's ctx; the frontend's own marks win."""
    if not isinstance(wire_prov, dict):
        return
    prov = getattr(ctx, _ATTR, None)
    if prov is None:
        prov = {}
        setattr(ctx, _ATTR, prov)
    for key, value in wire_prov.items():
        prov.setdefault(str(key), value)


def assemble(ctx, status: int, trace_id: Optional[str] = None) -> Dict:
    """The finished request's provenance record, from the ctx marks and
    the status: the tier defaults to ``render_cold`` (no cheaper layer
    claimed the request), and a 304 overrides every mark.  The QoS class
    (``server.pressure.is_bulk``) and the engaged prefix of the pressure
    ladder (``ladder``) are read here, at finish time; a tile whose
    quality ``drop_quality`` capped carries ``quality_capped``."""
    from ..server.pressure import active, is_bulk
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
    if m.get("quality_capped") is None \
            and getattr(ctx, "_pressure_quality_capped", False):
        record["quality_capped"] = 1
    try:
        bulk = is_bulk(ctx)
    except AttributeError:             # a ctx without tile or projection
        bulk = False
    record["qos"] = "bulk" if bulk else "interactive"
    governor = active()
    if governor is not None and governor.engaged_steps():
        record["ladder"] = ",".join(governor.engaged_steps())
    tokens = m.get("tokens")
    if tokens:
        record["tokens"] = round(float(tokens), 3)
    if trace_id:
        record["trace"] = trace_id
    return record


def header_value(record: Dict) -> str:
    """The compact ``k=v; k=v`` form of the debug header."""
    parts = []
    for key in ("tier", "member", "qos", "ladder", "tokens", "trace"):
        value = record.get(key)
        if value not in (None, "", "-"):
            parts.append(f"{key}={value}")
    flags = [f for f in FLAGS if record.get(f)]
    if flags:
        parts.append("flags=" + ",".join(flags))
    return "; ".join(parts)
