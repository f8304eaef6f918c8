"""The PyTorch port imports neither JAX nor any module of the JAX package,
and imports ``aiohttp`` and ``yaml`` only inside the functions that need
them.  No module of the port loads anything under ``scripts/`` (the JAX
sentinel loads ``scripts/bench_gate.py`` for its TPU watermarks), also
when the perf sentinel is built at the repo root."""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_SCRIPT = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None            # any `import jax` now raises
sys.modules["aiohttp"] = None        # so does a module-level aiohttp
sys.modules["yaml"] = None           # or yaml import
import omero_ms_image_region_tpu_torch as port
names = [port.__name__]
for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    names.append(info.name)
for name in names:
    importlib.import_module(name)
from omero_ms_image_region_tpu_torch.server import sentinel
from omero_ms_image_region_tpu_torch.server.config import AppConfig
engine = sentinel.engine_from_config(AppConfig().sentinel, member="local")
scripts = sorted(m for m, mod in sys.modules.items()
                 if "bench_gate" in m or "/scripts/" in str(
                     getattr(mod, "__file__", None) or ""))
leaked = sorted(m for m in sys.modules
                if m == "omero_ms_image_region_tpu"
                or m.startswith("omero_ms_image_region_tpu."))
print(json.dumps({"imported": names, "leaked": leaked,
                  "scripts": scripts, "watermarks": engine.watermarks,
                  "jax": [m for m in sys.modules
                          if m == "jax" or m.startswith("jax.")
                          if sys.modules[m] is not None]}))
"""


def test_port_imports_without_jax_or_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    # Every module of the slice was imported.
    for mod in ("kernels.build", "kernels.render", "kernels.jpeg",
                "ops.render", "ops.quantum", "ops.flip", "ops.lut",
                "ops.jpegenc", "native", "server.handler", "server.app",
                "server.__main__", "server.batcher", "server.singleflight",
                "io.store", "io.service", "io.staging", "io.devicecache",
                "utils.transient", "utils.telemetry", "utils.stopwatch",
                "utils.faultinject", "server.httpcache", "server.admission",
                "server.watchdog", "server.config", "server.errors",
                "services.metadata", "codecs", "flagship",
                "kernels.workloads", "ops.pyramid", "ops.projection",
                "ops.maskops", "io.tiff", "io.jpegdec", "io.ometiff",
                "io.ngff", "io.memory", "io.tiffwrite", "server.jobs",
                "ingest", "services.sessions", "services.db_metadata",
                "services.viewport", "services.prefetch", "io.romio",
                "io.jp2k", "services.cache", "jfif", "utils.linkprobe",
                "utils.adaptive", "server.prewarm", "utils.provenance",
                "services.diskcache", "services.warmstate",
                "server.execcache", "server.shutdown", "utils.sketch",
                "utils.decisions", "server.sentinel", "server.explain",
                "server.pressure", "kernels.staging", "server.sidecar",
                "server.shmring", "server.degraded", "refimpl",
                "kernels.mesh", "parallel.cluster", "parallel.mesh",
                "parallel.serve", "services.loadmodel",
                "server.autoscaler", "parallel.federation"):
        assert f"omero_ms_image_region_tpu_torch.{mod}" in doc["imported"]
    assert doc["leaked"] == []
    assert doc["jax"] == []
    assert doc["scripts"] == [] and doc["watermarks"] == {}
