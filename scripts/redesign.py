"""What the kernel redesign scripts (``scripts/k*_redesign.py``) share: a
parent commit's kernel source written into the git-ignored build
directory, the ptxas lines of a build, the timing in turns, and the two
yardsticks, ``floor_ms`` and ``copy_ms``.

Each script takes ``--parent REV``.  Where git is (any machine) the
parent's source is taken with ``git show REV:...``; on a machine without
git (a copy of the tree) the copy written there before is used.
"""

from __future__ import annotations

import statistics
import subprocess
from pathlib import Path
from typing import Callable, Dict, List, Sequence

ROOT = Path(__file__).resolve().parents[1]
CSRC = "omero_ms_image_region_tpu_torch/kernels/csrc"
TURNS = ("parent", "change", "change", "parent")


def parent_source(build_dir: Path, tag: str, rev: str, source: str,
                  headers: Sequence[str] = ()) -> Path:
    """The parent's ``kernels/csrc/<source>`` at ``rev``, as
    ``<tag>_parent_<source>`` in ``build_dir/<tag>_parent_<rev>/``, beside
    the parent's ``headers`` under their own names (the source includes
    them by name)."""
    where = build_dir / f"{tag}_parent_{rev.replace('/', '_')}"
    where.mkdir(parents=True, exist_ok=True)
    local = {source: f"{tag}_parent_{source}",
             **{name: name for name in headers}}
    for name, dest in local.items():
        proc = subprocess.run(["git", "show", f"{rev}:{CSRC}/{name}"],
                              cwd=ROOT, capture_output=True, text=True)
        if proc.returncode == 0:
            (where / dest).write_text(proc.stdout)
        elif not (where / dest).exists():
            raise RuntimeError(f"git show {rev}:{CSRC}/{name} failed and no "
                               f"copy is in {where}: run this script once "
                               f"where git is\n{proc.stderr}")
    return where / local[source]


def ptxas_lines(tag: str, log: str) -> None:
    """Print each kernel's entry, registers and spill lines of an nvcc
    ``-Xptxas -v`` log."""
    for line in log.splitlines():
        if ("Compiling entry" in line or "registers" in line
                or "spill" in line):
            print(f"ptxas {tag}: {line.strip()}", flush=True)


def turns(time_ms: Callable[[Callable[[], object]], float],
          fns: Dict[str, Callable[[], object]],
          order: Sequence[str] = TURNS) -> Dict[str, List[float]]:
    """Each of ``fns`` timed by ``time_ms`` in the turns ``order`` (by
    default parent, change, change, parent): the times a name."""
    got: Dict[str, List[float]] = {name: [] for name in dict.fromkeys(order)}
    for name in order:
        got[name].append(time_ms(fns[name]))
    return got


def means(got: Dict[str, List[float]]) -> Dict[str, float]:
    """``<name>_ms``: the mean of each name's turns."""
    return {f"{name}_ms": statistics.mean(t) for name, t in got.items()}


def floor_ms(torch, time_ms: Callable) -> float:
    """``time_ms`` of one trivial launch (a 4-byte ``zero_()``): the least
    any one-launch kernel shows under that timing."""
    tiny = torch.zeros(1, dtype=torch.int32, device="cuda")
    return time_ms(tiny.zero_)


class CopyTimer:
    """``copy_ms(n_bytes)``: ``time_ms`` of a device ``Tensor.copy_`` that
    moves ``n_bytes`` (half read, half written), once a size."""

    def __init__(self, torch, time_ms: Callable):
        self._torch, self._time_ms, self._got = torch, time_ms, {}

    def __call__(self, n_bytes: float) -> float:
        n = int(n_bytes) // 32 * 16
        if n not in self._got:
            src = self._torch.empty(n, dtype=self._torch.uint8,
                                    device="cuda")
            dst = self._torch.empty_like(src)
            self._got[n] = self._time_ms(lambda: dst.copy_(src))
            del src, dst
        return self._got[n]
