"""Ingest/export tooling: ``python -m omero_ms_image_region_tpu_torch.ingest``
(the JAX package's ``ingest.py``).

The reference's deployments lean on OMERO's importer (Bio-Formats) to
populate the binary repository; this CLI covers the same operational
needs for a standalone data directory:

  info <image_dir|tiff|zarr>         print geometry, levels, backend
  tiff-to-store <tiff> <image_dir>   OME-TIFF -> chunked pyramid layout
  store-to-tiff <image_dir> <tiff>   chunked pyramid -> tiled OME-TIFF
  to-ngff <src> <zarr_dir>           any readable source -> OME-NGFF
                                     (zarr v2 multiscales)
  pyramid <src> [--device cpu]       build the source's missing levels
                                     as an NGFF group beside it: the
                                     server's POST /pyramid job (K9 on
                                     the card unless --device cpu)

Conversions read plane by plane but do hold ONE full-resolution
[T, C, Z, H, W] copy (plus ~1/3 extra for the rebuilt pyramid levels)
while writing — size the host accordingly for WSI-scale inputs.  The
storage dtype is preserved; pyramid levels are rebuilt with the same
mean-pool reduction both writers share.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _open_source(path: str):
    import os

    from .io.ngff import NgffZarrSource, find_ngff
    from .io.ometiff import OmeTiffSource, find_tiff
    from .io.store import ChunkedPyramidStore

    if os.path.isdir(path):
        if os.path.exists(os.path.join(path, "meta.json")):
            return ChunkedPyramidStore(path), "chunked"
        ngff = find_ngff(path)
        if ngff is not None:
            return NgffZarrSource(ngff), "ome-ngff"
        tiff = find_tiff(path)
        if tiff is not None:
            return OmeTiffSource(tiff), "ome-tiff"
        raise SystemExit(
            f"{path}: no meta.json, NGFF markers, or TIFF found")
    return OmeTiffSource(path), "ome-tiff"


def cmd_info(args) -> int:
    src, backend = _open_source(args.path)
    try:
        sx, sy = src.resolution_descriptions()[0]
        print(f"backend:  {backend}")
        print(f"plane:    {sx} x {sy}")
        print(f"z/c/t:    {src.size_z} / {src.size_c} / {src.size_t}")
        print(f"dtype:    {np.dtype(src.dtype).name}")
        print(f"levels:   {src.resolution_descriptions()}")
        print(f"tile:     {src.tile_size()}")
    finally:
        src.close()
    return 0


def _gather_planes(src):
    """[T, C, Z, H, W] assembled via the sources' own stack reads."""
    sx, sy = src.resolution_descriptions()[0]
    out = np.empty((src.size_t, src.size_c, src.size_z, sy, sx),
                   dtype=src.dtype)
    for t in range(src.size_t):
        for c in range(src.size_c):
            out[t, c] = src.get_stack(c, t)
    return out


def cmd_tiff_to_store(args) -> int:
    from .io.ometiff import OmeTiffSource
    from .io.store import build_pyramid

    src = OmeTiffSource(args.tiff)
    try:
        planes = _gather_planes(src)
    finally:
        src.close()
    build_pyramid(planes, args.image_dir, chunk=(args.tile, args.tile),
                  min_level_size=args.min_level)
    print(f"wrote chunked pyramid at {args.image_dir}")
    return 0


def cmd_store_to_tiff(args) -> int:
    from .io.store import ChunkedPyramidStore
    from .io.tiffwrite import _OME_TYPE, write_ome_tiff

    src = ChunkedPyramidStore(args.image_dir)
    if np.dtype(src.dtype).name not in _OME_TYPE:
        src.close()
        raise SystemExit(
            f"{args.image_dir}: dtype {np.dtype(src.dtype).name} has no "
            f"OME-TIFF pixel type (supported: "
            f"{', '.join(sorted(_OME_TYPE))})")
    try:
        planes = _gather_planes(src)
    finally:
        src.close()
    write_ome_tiff(planes, args.tiff, tile=(args.tile, args.tile),
                   compression=args.compression,
                   min_level_size=args.min_level)
    print(f"wrote OME-TIFF at {args.tiff}")
    return 0


def cmd_to_ngff(args) -> int:
    from .io.ngff import write_ngff

    src, backend = _open_source(args.src)
    try:
        planes = _gather_planes(src)
    finally:
        src.close()
    write_ngff(planes, args.zarr_dir, chunk=(args.tile, args.tile),
               min_level_size=args.min_level,
               compressor=(None if args.compression == "none"
                           else args.compression))
    print(f"wrote OME-NGFF at {args.zarr_dir} (from {backend})")
    return 0


def cmd_pyramid(args) -> int:
    """Build an unpyramided source's multiscale NGFF levels through
    the SAME crash-safe job path the server's ``POST /pyramid`` runs
    (``server.jobs.PyramidJobManager``): K9 downsample, atomic per-level
    commits, resume-after-kill."""
    from .server.jobs import PyramidJobManager

    manager = PyramidJobManager(
        chunk=(args.tile, args.tile), min_level_size=args.min_level,
        compressor=(None if args.compression == "none"
                    else args.compression), device=args.device)
    try:
        job = manager.submit(args.src)
    except FileNotFoundError as e:
        print(f"error: no such source: {e}", file=sys.stderr)
        return 2
    try:
        manager.run_job_sync(job)
    except Exception as e:
        print(f"error: pyramid build failed: {e}", file=sys.stderr)
        return 1
    print(f"built {job.levels_done}/{job.levels_total} levels at "
          f"{job.dest}" + (" (resumed)" if job.resumed else ""))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m omero_ms_image_region_tpu_torch.ingest",
        description="Convert/inspect image-region data directories")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("info", help="print an image's geometry")
    p.add_argument("path")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("tiff-to-store",
                       help="OME-TIFF -> chunked pyramid dir")
    p.add_argument("tiff")
    p.add_argument("image_dir")
    p.add_argument("--tile", type=int, default=256)
    p.add_argument("--min-level", type=int, default=256)
    p.set_defaults(fn=cmd_tiff_to_store)

    p = sub.add_parser("store-to-tiff",
                       help="chunked pyramid dir -> tiled OME-TIFF")
    p.add_argument("image_dir")
    p.add_argument("tiff")
    p.add_argument("--tile", type=int, default=256)
    p.add_argument("--min-level", type=int, default=256)
    p.add_argument("--compression", choices=["none", "deflate"],
                   default="deflate")
    p.set_defaults(fn=cmd_store_to_tiff)

    p = sub.add_parser("to-ngff",
                       help="any readable source -> OME-NGFF zarr")
    p.add_argument("src")
    p.add_argument("zarr_dir")
    p.add_argument("--tile", type=int, default=256)
    p.add_argument("--min-level", type=int, default=256)
    p.add_argument("--compression", choices=["none", "zlib", "gzip"],
                   default="zlib")
    p.set_defaults(fn=cmd_to_ngff)

    p = sub.add_parser("pyramid",
                       help="build multiscale NGFF levels in place "
                            "(the server's POST /pyramid job path)")
    p.add_argument("src")
    p.add_argument("--tile", type=int, default=256)
    p.add_argument("--min-level", type=int, default=256)
    p.add_argument("--compression", choices=["none", "zlib", "gzip"],
                   default="zlib")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where K9 runs (cpu: its plain version)")
    p.set_defaults(fn=cmd_pyramid)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
