"""Serving across several members and devices.

Counterpart of the JAX package's ``parallel/``: :mod:`.fleet`, the
consistent-hash router (``FleetRouter``) over in-process members
(``LocalMember``) and render sidecars (``RemoteMember``); :mod:`.cluster`,
joining ``torch.distributed`` (one process per GPU); :mod:`.mesh`, the
``(data, chan)`` mesh and its sharded steps (K12); and :mod:`.serve`, the
``MeshRenderer`` of the ``parallel.enabled`` posture, its pod channel and
the ``--role pod-worker`` loop.  Only the federation (``federation.py``)
is not ported yet (ROADMAP Queue 1 item 5).
"""
