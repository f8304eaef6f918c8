"""HTML color string parsing.

Reimplements the color splitter consumed at
``ImageRegionRequestHandler.java:865-890`` (and by the mask renderer at
``ShapeMaskRequestHandler.java:103-105``):

    abc      -> (0xAA, 0xBB, 0xCC, 0xFF)
    abcd     -> (0xAA, 0xBB, 0xCC, 0xDD)
    abbccd   -> (0xAB, 0xBC, 0xCD, 0xFF)
    abbccdde -> (0xAB, 0xBC, 0xCD, 0xDE)

Returns None for anything unparseable (the reference logs and returns null).

Deliberate deviation: the reference's 3/4-char expansion is broken in Java
(``color += ch + ch`` promotes chars to ints, building digit strings like
"194" — so 3/4-char colors always return null despite the documented
table).  This module implements the documented/intended behavior, which is
also what OMERO.web's own Python splitHTMLColor does.
"""

from __future__ import annotations

from typing import Optional, Tuple


def split_html_color(color: str) -> Optional[Tuple[int, int, int, int]]:
    try:
        if len(color) in (3, 4):
            color = "".join(ch + ch for ch in color)
        if len(color) == 6:
            color += "FF"
        if len(color) == 8:
            return (
                int(color[0:2], 16),
                int(color[2:4], 16),
                int(color[4:6], 16),
                int(color[6:8], 16),
            )
    except (ValueError, TypeError):
        pass
    return None
