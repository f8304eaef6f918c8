"""K9's plain version, the port's ``downsample2_batch`` and the pyramid job
against the JAX package.

Every downsample is exact: ``mean2_int_plain`` and
``downsample2_batch(device="cpu")`` against the JAX ``downsample2_batch``
and the port's host reduction ``io.store._downsample2``, for uint8, int8,
uint16 and int16 (negatives and ties, sums of 2 mod 4, included), odd
sizes, a 1x3 plane and stacked leading dims, and for the host paths of
float32 and uint32.  The job run by both packages' ``run_job_sync`` on one
single-level OME-TIFF writes byte-identical ``.zgroup``, ``.zattrs``,
``.zarray`` and chunk files; a resumed build (a stale ``.lvl-2.tmp`` and a
committed level 1 left behind) removes the tmp dir, keeps level 1 and ends
byte-identical.  The ``ingest`` subcommands write what the JAX package's
write.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from omero_ms_image_region_tpu import ingest as jax_ingest
from omero_ms_image_region_tpu.io.tiffwrite import write_ome_tiff
from omero_ms_image_region_tpu.ops.pyramid import (
    downsample2_batch as jax_downsample2_batch)
from omero_ms_image_region_tpu.ops.pyramid import (
    n_pyramid_levels as jax_n_pyramid_levels)
from omero_ms_image_region_tpu.server.jobs import (
    PyramidJobManager as JaxPyramidJobManager)
from omero_ms_image_region_tpu_torch import ingest
from omero_ms_image_region_tpu_torch.io.store import _downsample2
from omero_ms_image_region_tpu_torch.ops.pyramid import (
    downsample2_batch, mean2_int, mean2_int_plain, n_pyramid_levels)
from omero_ms_image_region_tpu_torch.server.jobs import PyramidJobManager
from omero_ms_image_region_tpu_torch.utils import telemetry
from omero_ms_image_region_tpu_torch.utils.stopwatch import REGISTRY

INT_TYPES = (np.uint8, np.int8, np.uint16, np.int16)


def _ints(dtype, shape, seed):
    info = np.iinfo(dtype)
    return np.random.default_rng(seed).integers(
        info.min, info.max, size=shape, endpoint=True).astype(dtype)


def _with_ties(a):
    """Blocks whose sums are 2 mod 4 (rounding ties) in the first rows,
    negative ones where the type has a sign."""
    a = a.copy()
    lo = -3 if np.issubdtype(a.dtype, np.signedinteger) else 0
    a[..., 0, 0:8] = np.array([lo, lo, lo + 1, lo + 1, 2, 3, 5, 6],
                              a.dtype)
    a[..., 1, 0:8] = np.array([lo, lo, lo + 1, lo + 1, 3, 2, 6, 9],
                              a.dtype)
    return a


@pytest.mark.parametrize("shape", [(3, 37, 45), (2, 2, 64, 33), (1, 3),
                                   (4, 2, 2)])
@pytest.mark.parametrize("dtype", INT_TYPES)
def test_integer_downsample_is_exact(dtype, shape):
    planes = _ints(dtype, shape, 1)
    if shape[-1] >= 8 and shape[-2] >= 2:
        planes = _with_ties(planes)
    want = jax_downsample2_batch(planes)
    got = downsample2_batch(planes, device="cpu")
    assert got.dtype == want.dtype == dtype
    assert got.shape == want.shape
    assert np.array_equal(got, want)
    flat = planes.reshape(-1, *shape[-2:])
    assert np.array_equal(got.reshape(-1, *got.shape[-2:]), np.stack(
        [_downsample2(p) for p in flat]))
    if shape[-2] >= 2 and shape[-1] >= 2:
        x = torch.from_numpy(flat.view(np.int16) if dtype == np.uint16
                             else flat)
        if dtype == np.uint16:
            x = x.view(torch.uint16)
        plain = mean2_int_plain(x)
        assert plain.dtype == x.dtype
        assert torch.equal(plain, mean2_int(x))
        host = (plain.view(torch.int16) if dtype == np.uint16
                else plain).numpy().view(dtype)
        assert np.array_equal(host, want.reshape(host.shape))


@pytest.mark.parametrize("dtype", [np.float32, np.uint32])
def test_host_downsample_is_exact(dtype):
    rng = np.random.default_rng(2)
    planes = (rng.normal(0, 100, (2, 3, 33, 40)) if dtype == np.float32
              else rng.integers(0, 2 ** 32, (2, 3, 33, 40))).astype(dtype)
    got = downsample2_batch(planes, device="cpu")
    assert np.array_equal(got, jax_downsample2_batch(planes))
    assert got.dtype == dtype


@pytest.mark.parametrize("hw", [(8192, 8192), (256, 256), (255, 4096),
                                (100, 100), (1, 1), (513, 300)])
def test_level_count_matches_jax(hw):
    for min_size in (1, 64, 256):
        assert n_pyramid_levels(*hw, min_size) == \
            jax_n_pyramid_levels(*hw, min_size)


# ------------------------------------------------------------- the job

BARE = "5"


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """One bare OME-TIFF built by the JAX job and by the port's (each in
    its own copy of the tree)."""
    root = tmp_path_factory.mktemp("pyramid")
    src = root / "src" / BARE
    src.mkdir(parents=True)
    planes = np.random.default_rng(3).integers(
        0, 60000, size=(2, 1, 256, 200)).astype(np.uint16)
    write_ome_tiff(planes, str(src / "bare.tif"), tile=(64, 64),
                   n_levels=1)
    out = {}
    for name, manager in (
            ("jax", JaxPyramidJobManager(chunk=(64, 64), min_level_size=50)),
            ("port", PyramidJobManager(chunk=(64, 64), min_level_size=50,
                                       device="cpu"))):
        data = root / name
        shutil.copytree(root / "src", data)
        job = manager.submit(str(data / BARE))
        manager.run_job_sync(job)
        out[name] = (data / BARE / "pyramid.zarr", job)
    out["src"] = root / "src"
    return out


def _files(root):
    return {os.path.relpath(os.path.join(d, f), root): open(
        os.path.join(d, f), "rb").read()
        for d, _, names in os.walk(root) for f in names}


def test_job_writes_what_jax_writes(builds):
    (jax_root, jax_job), (port_root, port_job) = builds["jax"], \
        builds["port"]
    assert port_job.state == jax_job.state == "done"
    assert port_job.levels_done == port_job.levels_total == 3
    mine, theirs = _files(port_root), _files(jax_root)
    assert sorted(mine) == sorted(theirs)
    for name in (".zgroup", ".zattrs", "0/.zarray", "1/.zarray",
                 "2/.zarray"):
        assert name in mine
    assert [n for n in mine if mine[n] != theirs[n]] == []
    # Level 2 is 50x64: one chunk per channel.
    assert len([n for n in mine if n.startswith("2/")]) == 1 + 2
    spans = REGISTRY.snapshot()
    assert spans["pyramid.readSource"]["count"] >= 1
    assert spans["pyramid.downsample"]["count"] >= 2
    assert spans["pyramid.writeLevel"]["count"] >= 3


def test_resumed_job_skips_committed_levels(builds, tmp_path):
    port_root, _ = builds["port"]
    data = tmp_path / "resume"
    shutil.copytree(builds["src"], data)
    dest = data / BARE / "pyramid.zarr"
    dest.mkdir()
    shutil.copytree(port_root / "1", dest / "1")
    (dest / "1" / "kept").write_bytes(b"committed before the kill")
    (dest / ".lvl-2.tmp").mkdir()
    (dest / ".lvl-2.tmp" / "0.0.0.0.0").write_bytes(b"half a level")
    telemetry.reset()
    manager = PyramidJobManager(chunk=(64, 64), min_level_size=50,
                                device="cpu")
    job = manager.run_job_sync(manager.submit(str(data / BARE)))
    assert job.state == "done" and job.resumed
    assert not (dest / ".lvl-2.tmp").exists()
    assert (dest / "1" / "kept").exists()            # level 1 not rewritten
    assert telemetry.WORKLOADS.levels_committed == 2
    assert telemetry.WORKLOADS.jobs == {"submitted": 1, "resumed": 1,
                                        "completed": 1}
    mine = _files(dest)
    mine.pop("1/kept")
    assert mine == _files(port_root)


def test_an_unreadable_source_fails_the_job(tmp_path):
    (tmp_path / "9").mkdir()
    manager = PyramidJobManager(device="cpu")
    job = manager.submit(str(tmp_path / "9"))
    with pytest.raises(ValueError, match="no meta.json"):
        manager.run_job_sync(job)
    assert job.state == "failed" and "no meta.json" in job.error


@pytest.mark.parametrize("cmd", ["tiff-to-store", "store-to-tiff",
                                 "to-ngff", "pyramid", "info"])
def test_ingest_writes_what_jax_writes(builds, tmp_path, cmd, capsys):
    src = builds["src"] / BARE
    outs = {}
    for name, main in (("jax", jax_ingest.main), ("port", ingest.main)):
        work = tmp_path / name
        shutil.copytree(builds["src"], work)
        if cmd == "tiff-to-store":
            argv = [cmd, str(work / BARE / "bare.tif"), str(work / "st"),
                    "--tile", "64", "--min-level", "50"]
            target = work / "st"
        elif cmd == "store-to-tiff":
            assert jax_ingest.main(["tiff-to-store", str(src / "bare.tif"),
                                    str(work / "st"), "--tile", "64"]) == 0
            argv = [cmd, str(work / "st"), str(work / "out.ome.tif"),
                    "--tile", "64", "--min-level", "50"]
            target = work / "out.ome.tif"
        elif cmd == "to-ngff":
            argv = [cmd, str(work / BARE), str(work / "o.zarr"),
                    "--tile", "64", "--min-level", "50"]
            target = work / "o.zarr"
        elif cmd == "pyramid":
            argv = [cmd, str(work / BARE), "--tile", "64", "--min-level",
                    "50"] + (["--device", "cpu"] if name == "port" else [])
            target = work / BARE / "pyramid.zarr"
        else:
            argv = [cmd, str(work / BARE)]
            target = None
        capsys.readouterr()
        assert main(argv) == 0
        printed = capsys.readouterr().out.replace(str(work), "<work>")
        outs[name] = (printed, _files(target) if target is not None and
                      target.is_dir() else
                      (target.read_bytes() if target else None))
    assert outs["port"] == outs["jax"]
