"""Host-side helpers: HTML color parsing and SipHash cache keys."""
