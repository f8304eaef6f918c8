"""Lookup-table parsing and registry.

Replaces the consumed surface of ``ome.model.display.LutReader`` /
``LutReaderFactory`` as used by ``LutProviderImpl.java:42-58`` (scan a
directory tree for ``*.lut`` files at startup, key by basename) and
``:63-73`` (resolve readers for channel bindings).

Supported formats (the ImageJ family the OMERO LutReaderFactory reads):
  * binary, 768 bytes: 256 R then 256 G then 256 B
  * binary, 800 bytes: 32-byte NIH Image header then the 768 payload
  * binary, N*3 planar (3 consecutive channel planes) for N<=256, stretched
    to 256 entries
  * text: whitespace/comma separated rows of ``r g b`` or ``index r g b``

Parsed LUTs are folded by ``ops.render.build_channel_tables`` into the
per-channel f32 tables the LUT render kernel stages in shared memory.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np


def parse_lut_bytes(data: bytes) -> np.ndarray:
    """Parse one .lut payload into a (256, 3) uint8 table."""
    n = len(data)
    if n == 768:
        arr = np.frombuffer(data, dtype=np.uint8)
        return arr.reshape(3, 256).T.copy()
    if n == 800:
        return parse_lut_bytes(data[32:])
    # Try text
    try:
        text = data.decode("ascii")
    except UnicodeDecodeError:
        text = None
    if text is not None and any(c.isdigit() for c in text):
        rows: List[Tuple[int, int, int]] = []
        for line in text.replace(",", " ").splitlines():
            parts = line.split()
            if not parts:
                continue
            try:
                vals = [int(float(p)) for p in parts]
            except ValueError:
                continue
            if len(vals) >= 4:
                vals = vals[1:4]  # index r g b
            if len(vals) >= 3:
                rows.append((vals[0], vals[1], vals[2]))
        if rows:
            table = np.array(rows, dtype=np.int64)
            table = np.clip(table, 0, 255).astype(np.uint8)
            return _pad_to_256(table)
    # Fallback: planar binary of arbitrary length divisible by 3
    if n % 3 == 0 and 0 < n <= 768:
        m = n // 3
        arr = np.frombuffer(data, dtype=np.uint8)
        return _pad_to_256(arr.reshape(3, m).T.copy())
    raise ValueError(f"Unrecognized LUT payload of {n} bytes")


def _pad_to_256(table: np.ndarray) -> np.ndarray:
    if table.shape[0] == 256:
        return table
    if table.shape[0] > 256:
        return table[:256]
    # Stretch by nearest-neighbour to 256 entries.
    idx = np.linspace(0, table.shape[0] - 1, 256).round().astype(np.int64)
    return table[idx]


class LutProvider:
    """Startup-scanned LUT registry (= LutProviderImpl).

    Scans ``root`` recursively for ``*.lut`` files, keyed by lower-cased
    basename (the reference keys by ``getName().toLowerCase()``,
    ``LutProviderImpl.java:50-55``).  Unparseable files are skipped, matching
    the reference's warn-and-continue behavior.
    """

    def __init__(self, root: Optional[str] = None):
        self.tables: Dict[str, int] = {}
        self._rows: List[np.ndarray] = []
        if root and os.path.isdir(root):
            for dirpath, _dirnames, filenames in os.walk(root):
                for fn in sorted(filenames):
                    if not fn.lower().endswith(".lut"):
                        continue
                    path = os.path.join(dirpath, fn)
                    try:
                        with open(path, "rb") as f:
                            table = parse_lut_bytes(f.read())
                    except (ValueError, OSError):
                        continue
                    self.add(fn.lower(), table)

    def add(self, name: str, table: np.ndarray) -> int:
        """Register a (256,3) uint8 table under ``name``; returns its row."""
        if table.shape != (256, 3):
            raise ValueError(f"LUT table must be (256,3), got {table.shape}")
        name = name.lower()
        if name in self.tables:
            self._rows[self.tables[name]] = table.astype(np.uint8)
            return self.tables[name]
        idx = len(self._rows)
        self._rows.append(table.astype(np.uint8))
        self.tables[name] = idx
        return idx

    def get(self, name: str) -> Optional[np.ndarray]:
        idx = self.tables.get(name.lower())
        return None if idx is None else self._rows[idx]

