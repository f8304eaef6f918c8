"""Status-mapped service exceptions.

  ========================  ======  ==============
  exception                 status  body
  ========================  ======  ==============
  BadRequestError           400     message text
  NotFoundError             404     empty
  DeadlineExceededError     504     JSON ``{"error": ...}``
  anything else             500     empty
  ========================  ======  ==============

``DeadlineExceededError`` lives in ``utils.transient``.
"""


class BadRequestError(ValueError):
    """Parameter validation failure -> HTTP 400 (the reference's
    IllegalArgumentException path, ``ImageRegionVerticle.java:163-188``)."""


class NotFoundError(Exception):
    """Maps to HTTP 404 (the reference's ObjectNotFound / unreadable /
    unrenderable outcomes; ``ImageRegionVerticle.java:163-188``)."""
