"""Serving across several members: the consistent-hash fleet.

Counterpart of the JAX package's ``parallel/``.  :mod:`.fleet` is the
router (``FleetRouter``) over in-process members (``LocalMember``, each
with its own renderer and raw cache on its ``torch.device``) and render
sidecars (``RemoteMember``).  The multi-device mesh (``parallel/mesh.py``,
``serve.py``, ``cluster.py``) and the federation (``federation.py``) are
not ported yet (ROADMAP Queue 1 items 5 and 6).
"""
