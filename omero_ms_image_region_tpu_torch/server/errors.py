"""Status-mapped service exceptions.

  ========================  ======  ================================
  exception                 status  body
  ========================  ======  ================================
  BadRequestError           400     message text
  NotFoundError             404     empty
  OverloadedError           503     JSON ``{"error": ...}`` +
                                    ``Retry-After``
  ConnectionError           503     JSON ``{"error": ...}`` +
                                    ``Retry-After`` (the watchdog's
                                    escalation of a stuck lane)
  DeadlineExceededError     504     JSON ``{"error": ...}``
  anything else             500     empty
  ========================  ======  ================================

``DeadlineExceededError`` lives in ``utils.transient``.  No error response
carries cache headers.
"""


class BadRequestError(ValueError):
    """Parameter validation failure -> HTTP 400 (the reference's
    IllegalArgumentException path, ``ImageRegionVerticle.java:163-188``)."""


class NotFoundError(Exception):
    """Maps to HTTP 404 (the reference's ObjectNotFound / unreadable /
    unrenderable outcomes; ``ImageRegionVerticle.java:163-188``)."""


class OverloadedError(Exception):
    """The service refuses work it cannot finish (an admission shed).
    Maps to HTTP 503 with a ``Retry-After`` of
    ``max(1, round(retry_after_s))`` seconds."""

    def __init__(self, message: str = "service overloaded",
                 retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = max(0.0, float(retry_after_s))
