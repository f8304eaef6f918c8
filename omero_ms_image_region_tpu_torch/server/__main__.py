"""``python -m omero_ms_image_region_tpu_torch.server [--config FILE]``

Reads the JAX package's YAML (``conf/config.example.yaml``; see
``server.config`` for what the port serves of it).  The flags override the
file.  SIGTERM or SIGINT runs the shutdown chain (``server.shutdown``: the
warm-state snapshot with ``persistence`` on, then the flight-recorder dump)
before the services close.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    """The config the command line describes, and the device."""
    from .config import AppConfig

    parser = argparse.ArgumentParser(
        prog="python -m omero_ms_image_region_tpu_torch.server",
        description="Serve render_image_region / render_image over a data "
                    "directory of chunked pyramids (<dir>/<imageId>/).")
    parser.add_argument("--config", help="YAML config path")
    parser.add_argument("--port", type=int)
    parser.add_argument("--data-dir")
    parser.add_argument("--lut-root",
                        help="directory scanned for *.lut files")
    parser.add_argument("--device", default="cuda",
                        help="torch device to render on (default cuda)")
    parser.add_argument("--request-deadline-ms", type=float,
                        help="time budget of a render request; a request "
                             "over it gets a 504 (0: unbounded)")
    args = parser.parse_args(argv)
    config = (AppConfig.from_yaml(args.config) if args.config
              else AppConfig())
    if args.port is not None:
        config.port = args.port
    if args.data_dir is not None:
        config.data_dir = args.data_dir
    if args.lut_root is not None:
        config.lut_root = args.lut_root
    if args.request_deadline_ms is not None:
        config.fault_tolerance.request_deadline_ms = args.request_deadline_ms
    return config, args.device


def main(argv=None) -> None:
    from .app import configure_logging, create_app, run_app

    config, device = parse_args(argv)
    configure_logging(config)
    run_app(create_app(config, device), config)


if __name__ == "__main__":
    main()
