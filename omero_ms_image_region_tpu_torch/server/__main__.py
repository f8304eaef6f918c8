"""``python -m omero_ms_image_region_tpu_torch.server --data-dir DIR``"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m omero_ms_image_region_tpu_torch.server",
        description="Serve render_image_region / render_image over a data "
                    "directory of chunked pyramids (<dir>/<imageId>/).")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--lut-root", default=None,
                        help="directory scanned for *.lut files")
    parser.add_argument("--device", default="cuda",
                        help="torch device to render on (default cuda)")
    parser.add_argument("--request-deadline-ms", type=float, default=0.0,
                        help="time budget of a render request; a request "
                             "over it gets a 504 (default 0: unbounded)")
    args = parser.parse_args(argv)

    from aiohttp import web

    from .app import create_app
    web.run_app(create_app(args.data_dir, args.lut_root, args.device,
                           request_deadline_ms=args.request_deadline_ms),
                port=args.port)


if __name__ == "__main__":
    main()
