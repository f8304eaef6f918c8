"""Serving across several members and devices.

Counterpart of the JAX package's ``parallel/``: :mod:`.fleet`, the
consistent-hash router (``FleetRouter``) over in-process members
(``LocalMember``) and render sidecars (``RemoteMember``); :mod:`.cluster`,
joining ``torch.distributed`` (one process per GPU); :mod:`.mesh`, the
``(data, chan)`` mesh and its sharded steps (K12); and :mod:`.serve`, the
``MeshRenderer`` of the ``parallel.enabled`` posture, its pod channel and
the ``--role pod-worker`` loop; and :mod:`.federation`, the cross-host
federation (the digest-agreed manifest, gossip, quorum, epoch rolls and
the cross-host warm handoff) over the fleet and the sidecar wire.
"""

from . import federation  # noqa: F401,E402
