"""The elastic fleet autoscaler: the controller that decides fleet size.

Counterpart of the JAX package's ``server/autoscaler.py``, making the same
decisions on the same signals (``tests/test_torch_autoscaler.py`` drives
both controllers tick for tick on one virtual clock).  A tick-driven policy
(hysteresis and cooldown, with an injectable clock, as ``server.pressure``)
reads the fleet's queue per routable lane, the pressure governor's level,
the hottest promoted route's replica pressure
(``parallel.fleet.FleetRouter.replica_pressure``, with
``hotkey.scale-factor``) and, optionally, a predicted demand, and moves a
provisioned member set between ``floor`` and ``ceiling``:

* **scale-down** is ``FleetRouter.drain_member(intent="autoscale")``: the
  member settles its in-flight work, its raw-cache shard is prestaged warm
  onto its ring successors, and it stops taking routes.  The ``autoscale``
  intent keeps it out of ``drain.fail-readyz``'s 503;
* **scale-up** is ``FleetRouter.undrain_member``: the member rejoins its
  arcs and the shard it held at its drain is replayed back into it
  (pre-stage-back), so its first routed GETs hit its raw cache.

With a ``lifecycle`` (``server.sidecar.SidecarUnitLifecycle``, from
``autoscaler.unit-config``) a scale-down also stops the parked member's
sidecar process once its drain settled, and a scale-up restarts it, and
waits for its socket, before the undrain.  A failed restart keeps the
member parked for the next attempt.

Safety: the routable and the active members never go below ``floor`` by a
scale-down (deaths count against the budget); one scale operation is in
flight at a time (a tick during one is ``blocked:busy``; the victim is
reserved synchronously on the tick); only members this controller drained
are undrained; transitions are ``cooldown-s`` apart and need ``hold-ticks``
consecutive readings.  Each change of verdict is one ``kind=autoscaler``
record of ``utils.decisions`` with its signals, and its measured outcome
``outcome_horizon_ticks`` ticks later.  Surfaces: ``GET /admin/autoscaler``
(:meth:`Autoscaler.status`), ``/readyz``'s ``autoscaler`` annotation
(:meth:`Autoscaler.summary`), ``imageregion_autoscaler_*`` and the
``autoscale.up`` / ``autoscale.down`` / ``autoscale.blocked`` flight
events.

A federated host that lost its quorum (``parallel.federation
.quorum_allow("autoscaler")``) makes no transition: the tick answers
``blocked:quorum`` (a refusal counted), since the majority side may be
scaling the same members.  With no quorum tracker every transition is
allowed.  The provisioned fleet a federation's floor is held to is its
manifest's members (``server.config``).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Callable, List, Optional

from ..utils import decisions, telemetry

log = logging.getLogger("omero_ms_image_region_tpu_torch.autoscaler")

# Closed blocked-reason vocabulary (the ``reason`` label on
# imageregion_autoscaler_blocked_total — never caller-minted).
BLOCKED_REASONS = ("busy", "cooldown", "floor", "ceiling", "no-member",
                   "quorum")


class Autoscaler:
    """Tick-driven elastic controller over a ``FleetRouter``.

    ``demand_source`` (optional) returns the session model's predicted
    offered load in requests/s (e.g. viewport-tracked sessions x the
    per-session steady rate); with ``lane-capacity-tps`` calibrated
    from a CAPACITY record it becomes the third scale signal alongside
    queue depth and the pressure level.  ``clock`` is injectable so
    tests drive cooldown/hold deterministically (the
    ``server.pressure`` idiom)."""

    def __init__(self, config, router, governor=None,
                 demand_source: Optional[Callable[[], Optional[float]]]
                 = None,
                 drain_kwargs: Optional[dict] = None,
                 lifecycle=None,
                 clock: Callable[[], float] = time.monotonic):
        self.config = config
        self.router = router
        self.governor = governor
        self.demand_source = demand_source
        self.drain_kwargs = dict(drain_kwargs or {})
        # Sidecar-unit process lifecycle (server.sidecar
        # SidecarUnitLifecycle duck type: sync ``stop(name)`` /
        # ``start(name)``, both idempotent): with it, a scale-down
        # actually STOPS the parked member's process once its drain
        # settles (the shard handoff must finish first — the bytes
        # live in that process), and a scale-up RESTARTS the unit
        # (blocking until its socket accepts) BEFORE undraining, so
        # routes never land on a dead socket.  None = the
        # pre-provisioned posture (park/rejoin warm processes).
        self.lifecycle = lifecycle
        self.clock = clock
        self._up_streak = 0
        self._down_streak = 0
        # Far enough in the past that the first transition is never
        # cooldown-blocked (clock() may legally start at 0).
        self._last_transition: Optional[float] = None
        self._op: Optional[asyncio.Task] = None
        # LIFO of members THIS controller drained: scale-up rejoins
        # the most recently parked member (its manifest is freshest).
        self._scaled_down: List[str] = []
        self.transitions: List[dict] = []
        self.last_blocked: Optional[str] = None
        # Decision-ledger state: monotonically counted ticks key the
        # measured-outcome probes (N ticks after a verdict, did the
        # queue actually move?), and the steady flag makes "steady" a
        # TRANSITION record, not a per-tick drumbeat.
        self._tick_no = 0
        self._outcome_probes: List[dict] = []
        self._steady = False
        telemetry.AUTOSCALER.set_bounds(self.config.floor,
                                        self.ceiling())

    # -------------------------------------------------------- membership

    def ceiling(self) -> int:
        c = self.config.ceiling
        return len(self.router.order) if c <= 0 \
            else min(c, len(self.router.order))

    def active_members(self) -> List[str]:
        """Members currently accepting routes (not draining) — the
        figure the floor invariant is stated over."""
        return [n for n in self.router.order
                if not self.router.members[n].draining]

    def routable_members(self) -> List[str]:
        return [n for n in self.active_members()
                if self.router.members[n].healthy]

    # ----------------------------------------------------------- signals

    def signals(self) -> dict:
        routable = self.routable_members()
        lanes = self.router.lane_width * max(1, len(routable))
        depth = self.router.queue_depth()
        demand = None
        if self.demand_source is not None:
            try:
                demand = self.demand_source()
            except Exception:
                demand = None
        level = self.governor.level if self.governor is not None else 0
        capacity_tps = (len(routable) * self.router.lane_width
                        * self.config.lane_capacity_tps)
        # Hot-key replica pressure (parallel.fleet): the hottest
        # promoted route's heat in promotion-threshold units —
        # "one plane is outrunning one member", a reason to grow that
        # plain queue depth can miss while balancing absorbs the skew.
        replica_fn = getattr(self.router, "replica_pressure", None)
        replica_pressure = 0.0
        if replica_fn is not None:
            try:
                replica_pressure = float(replica_fn() or 0.0)
            except Exception:
                replica_pressure = 0.0
        return {
            "queue_depth": depth,
            "queue_per_lane": depth / lanes,
            "pressure_level": level,
            "demand_tps": demand,
            "capacity_tps": capacity_tps,
            "replica_pressure": replica_pressure,
        }

    def _hot_scale_factor(self) -> float:
        """The replica-pressure scale-up trigger (``hotkey.scale-
        factor`` off the router's config; 0 disables)."""
        hotkey = getattr(self.router, "hotkey", None)
        try:
            return float(getattr(hotkey, "scale_factor", 0.0) or 0.0)
        except (TypeError, ValueError):
            return 0.0

    def _wants(self, sig: dict) -> Optional[str]:
        c = self.config
        up = sig["queue_per_lane"] >= c.queue_high_per_lane
        if sig["pressure_level"] >= 2:       # critical: grow early
            up = True
        hot_factor = self._hot_scale_factor()
        if hot_factor > 0 \
                and sig.get("replica_pressure", 0.0) >= hot_factor:
            # Sustained demand on one plane is holding multiples of
            # the promotion threshold: replicas are absorbing it for
            # now, but the set is bounded — grow the fleet so the
            # chain prefix has more members to spread over.
            up = True
        demand = sig["demand_tps"]
        if (demand is not None and c.lane_capacity_tps > 0
                and demand > sig["capacity_tps"]):
            up = True
        if up:
            return "up"
        routable = len(self.routable_members())
        down = (sig["queue_per_lane"] <= c.queue_low_per_lane
                and sig["pressure_level"] == 0)
        if down and demand is not None and c.lane_capacity_tps > 0:
            # Shrinking must leave enough measured capacity for the
            # PREDICTED demand, not just the instantaneous queue — a
            # quiet second inside a busy day must not shed a member
            # the next minute needs back.
            after = ((routable - 1) * self.router.lane_width
                     * c.lane_capacity_tps)
            down = demand <= after
        return "down" if down else None

    # ---------------------------------------------------- decision ledger

    @staticmethod
    def _snap(sig: dict) -> dict:
        """The signal snapshot a decision record carries: everything
        the policy read this tick, so the ledger answers "why" without
        a second source."""
        return {
            "queue_depth": sig["queue_depth"],
            "queue_per_lane": round(sig["queue_per_lane"], 4),
            "pressure_level": sig["pressure_level"],
            "demand_tps": sig["demand_tps"],
            "capacity_tps": sig["capacity_tps"],
            "replica_pressure": round(
                sig.get("replica_pressure", 0.0), 4),
        }

    def _decide(self, verdict: str, sig: dict, member: str = "",
                **detail) -> None:
        """One ledger record for this tick's verdict, plus an outcome
        probe that measures the queue ``outcome-horizon-ticks`` ticks
        from now — the record says what the controller believed, the
        outcome says whether the fleet agreed."""
        doc = dict(detail)
        doc["signals"] = self._snap(sig)
        seq = decisions.record("autoscaler", verdict, member=member,
                               detail=doc)
        if seq >= 0:
            self._outcome_probes.append({
                "seq": seq, "tick": self._tick_no,
                "queue_depth": sig["queue_depth"],
                "active": len(self.active_members()),
            })

    def _resolve_outcomes(self, sig: dict) -> None:
        """Attach measured outcomes to verdicts whose horizon has
        elapsed (ring + spool via ``decisions.resolve``)."""
        horizon = max(1, decisions.LEDGER.outcome_horizon_ticks)
        due = [p for p in self._outcome_probes
               if self._tick_no - p["tick"] >= horizon]
        if not due:
            return
        self._outcome_probes = [p for p in self._outcome_probes
                                if self._tick_no - p["tick"] < horizon]
        active = len(self.active_members())
        for probe in due:
            decisions.resolve(probe["seq"], {
                "ticks": self._tick_no - probe["tick"],
                "queue_depth": sig["queue_depth"],
                "queue_depth_delta":
                    sig["queue_depth"] - probe["queue_depth"],
                "active": active,
                "active_delta": active - probe["active"],
            })

    # ------------------------------------------------------------ policy

    def _blocked(self, reason: str, want: str, sig: dict) -> str:
        telemetry.AUTOSCALER.count_blocked(reason)
        if reason != self.last_blocked:
            # Tape hygiene: a fleet parked at its floor refuses the
            # same want every tick — the counter carries the rate,
            # the flight ring records the TRANSITION (a steady
            # blocked:floor at 3 ticks/s would evict every useful
            # event from the black box within minutes).  The decision
            # ledger shares the transition gate: one "blocked" record
            # per posture change, with the signals that forced it.
            telemetry.FLIGHT.record("autoscale.blocked",
                                    reason=reason, want=want)
            self._decide("blocked", sig, reason=reason, want=want)
        self.last_blocked = reason
        self._steady = False
        return f"blocked:{reason}"

    def _publish(self) -> None:
        telemetry.AUTOSCALER.set_active(len(self.active_members()))
        telemetry.AUTOSCALER.set_bounds(self.config.floor,
                                        self.ceiling())

    def tick(self) -> Optional[str]:
        """One policy evaluation.  Returns "up"/"down" on a
        transition, "blocked:<reason>" when one was wanted but
        refused, None when steady — the drill and the property tests
        read this verdict directly."""
        now = self.clock()
        sig = self.signals()
        self._tick_no += 1
        self._resolve_outcomes(sig)
        want = self._wants(sig)
        if want == "up":
            self._up_streak += 1
            self._down_streak = 0
        elif want == "down":
            self._down_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = 0
            self._down_streak = 0
        try:
            if want is None:
                if not self._steady:
                    # "steady" is a transition record too: the tick
                    # the controller STOPPED wanting anything closes
                    # the previous episode in the ledger.
                    self._decide("steady", sig)
                    self._steady = True
                return None
            hold = self.config.hold_ticks
            if (want == "up" and self._up_streak < hold) \
                    or (want == "down" and self._down_streak < hold):
                # Held by hysteresis: not yet a decision — the ledger
                # records verdicts, not the debounce.
                return None
            if self._op is not None and not self._op.done():
                return self._blocked("busy", want, sig)
            if (self._last_transition is not None
                    and now - self._last_transition
                    < self.config.cooldown_s):
                return self._blocked("cooldown", want, sig)
            from ..parallel import federation
            if not federation.quorum_allow("autoscaler"):
                # Fenced minority: a membership transition is the ring
                # change a partition forbids (the majority may be scaling
                # the same members).
                return self._blocked("quorum", want, sig)
            if want == "up":
                return self._scale_up(now, sig)
            return self._scale_down(now, sig)
        finally:
            self._publish()

    def _record(self, action: str, member: str, now: float,
                sig: dict) -> None:
        self._last_transition = now
        self._up_streak = 0
        self._down_streak = 0
        self.last_blocked = None
        self._steady = False
        self._decide(action, sig, member=member)
        doc = {"action": action, "member": member, "t": now,
               "active": len(self.active_members()),
               "queue_depth": sig["queue_depth"]}
        self.transitions.append(doc)
        if len(self.transitions) > 64:
            # Bounded history: status() shows the recent tail, the
            # counters/flight ring carry the totals — a long-lived
            # oscillating fleet must not grow this list forever.
            del self.transitions[:-64]
        telemetry.AUTOSCALER.count_transition(action)
        telemetry.FLIGHT.record(
            f"autoscale.{action}", member=member,
            active=doc["active"], queue=sig["queue_depth"],
            demand=sig["demand_tps"])
        log.info("autoscale %s: member %s (active %d, queue %d)",
                 action, member, doc["active"], sig["queue_depth"])

    def _scale_up(self, now: float, sig: dict) -> str:
        if len(self.active_members()) + 1 > self.ceiling():
            return self._blocked("ceiling", "up", sig)
        # Only members THIS controller parked are candidates: an
        # operator's drain is an operator's decision.
        while self._scaled_down:
            name = self._scaled_down[-1]
            member = self.router.members.get(name)
            if (member is not None and member.draining
                    and getattr(member, "drain_intent",
                                None) == "autoscale"):
                break
            self._scaled_down.pop()      # operator took it over
        else:
            return self._blocked("no-member", "up", sig)
        name = self._scaled_down.pop()
        if self.lifecycle is not None:
            # Unit-managed member: restart its process FIRST (blocking
            # spawn + socket wait, off-loop), undrain only once the
            # socket accepts.  The reservation (popped above) and the
            # transition record are taken synchronously on this tick,
            # so concurrent ticks see the op in flight (blocked:busy).
            async def _up() -> None:
                try:
                    await asyncio.to_thread(self.lifecycle.start, name)
                except Exception:
                    # Spawn failed: re-park the member for the next
                    # attempt; it is still draining, still ours.
                    log.warning("autoscale unit start of %s failed; "
                                "re-parked", name, exc_info=True)
                    self._scaled_down.append(name)
                    return
                member = self.router.members.get(name)
                if member is not None and hasattr(member, "revive"):
                    member.revive()
                self.router.undrain_member(name)

            if self._has_loop():
                self._op = asyncio.get_running_loop().create_task(_up())
            else:
                # Sync caller with no loop: do the start + undrain
                # INLINE (blocking is the sync caller's bargain) —
                # discarding the coroutine would leak the member:
                # stopped process, still draining, no longer parked.
                self._op = None
                try:
                    self.lifecycle.start(name)
                except Exception:
                    log.warning("autoscale unit start of %s failed; "
                                "re-parked", name, exc_info=True)
                    self._scaled_down.append(name)
                    return self._blocked("no-member", "up", sig)
                member = self.router.members.get(name)
                if member is not None and hasattr(member, "revive"):
                    member.revive()
                self.router.undrain_member(name)
            self._record("up", name, now, sig)
            return "up"
        # undrain is synchronous (the pre-stage-back replay rides it
        # as a background task the router tracks).
        self.router.undrain_member(name)
        self._record("up", name, now, sig)
        return "up"

    def _scale_down(self, now: float, sig: dict) -> str:
        routable = self.routable_members()
        if len(routable) - 1 < self.config.floor \
                or len(self.active_members()) - 1 < self.config.floor:
            # Routable AND active: deaths spend the shrink budget too
            # (a dead-but-undrained member still owes the floor its
            # comeback), and either bound alone could be gamed by the
            # other's race.
            return self._blocked("floor", "down", sig)
        # The LAST routable member in stack order (never member 0 —
        # the mesh/bulk lane — while anything else can go).
        routable_set = set(routable)
        candidates = [n for n in reversed(self.router.order)
                      if n in routable_set]
        victim = None
        for name in candidates:
            if name != self.router.order[0] or len(candidates) == 1:
                victim = name
                break
        if victim is None:
            return self._blocked("no-member", "down", sig)
        member = self.router.members[victim]
        # SYNCHRONOUS reservation on this loop step: the member stops
        # being active/routable NOW, so a concurrent tick (or a
        # concurrent floor check) sees the post-drain world before the
        # drain coroutine has even started.
        member.draining = True
        member.drain_intent = "autoscale"
        self._scaled_down.append(victim)

        async def _drain() -> None:
            try:
                await self.router.drain_member(
                    victim, intent="autoscale", **self.drain_kwargs)
            except Exception:
                log.warning("autoscale drain of %s failed", victim,
                            exc_info=True)
                return
            if self.lifecycle is not None:
                # Drain settled and the shard handed off: stop the
                # parked member's PROCESS — elasticity that releases
                # real memory/devices, not a warm park.  Strictly
                # after the handoff (the warm bytes live in that
                # process until it finishes).
                try:
                    await asyncio.to_thread(self.lifecycle.stop,
                                            victim)
                except Exception:
                    log.warning("autoscale unit stop of %s failed",
                                victim, exc_info=True)

        if self._has_loop():
            self._op = asyncio.get_running_loop().create_task(_drain())
        else:
            # Sync caller with no loop (property tests drive the
            # policy alone): the reservation stands; the settle and
            # handoff belong to the async path.
            self._op = None
            telemetry.DRAIN.set_state(victim, "draining")
        self._record("down", victim, now, sig)
        return "down"

    @staticmethod
    def _has_loop() -> bool:
        try:
            asyncio.get_running_loop()
            return True
        except RuntimeError:
            return False

    async def wait_op(self) -> None:
        """Await the in-flight scale operation, if any (drills and
        scripted rolls)."""
        if self._op is not None:
            await self._op

    # ------------------------------------------------------------ status

    def status(self) -> dict:
        sig = self.signals()
        now = self.clock()
        cooldown_left = 0.0
        if self._last_transition is not None:
            cooldown_left = max(
                0.0, self.config.cooldown_s
                - (now - self._last_transition))
        return {
            "enabled": True,
            "floor": self.config.floor,
            "ceiling": self.ceiling(),
            "active": self.active_members(),
            "routable": self.routable_members(),
            "autoscale_drained": [
                n for n in self.router.order
                if self.router.members[n].draining
                and getattr(self.router.members[n], "drain_intent",
                            None) == "autoscale"],
            "cooldown_remaining_s": round(cooldown_left, 3),
            "op_in_flight": (self._op is not None
                             and not self._op.done()),
            "last_blocked": self.last_blocked,
            "transitions": self.transitions[-16:],
            "signals": sig,
        }

    def summary(self) -> str:
        """One-line /readyz annotation."""
        return (f"{len(self.active_members())}/{self.ceiling()} "
                f"active (floor {self.config.floor})")

    # ------------------------------------------------------------ runner

    async def run(self) -> None:
        """Asyncio tick loop (the governor's idiom); the app's
        robustness startup hook owns the task."""
        interval = max(0.05, self.config.interval_s)
        while True:
            await asyncio.sleep(interval)
            try:
                self.tick()
            except Exception:
                log.warning("autoscaler tick failed", exc_info=True)
