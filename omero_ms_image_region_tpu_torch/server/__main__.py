"""``python -m omero_ms_image_region_tpu_torch.server [--config FILE]``

Reads the JAX package's YAML (``conf/config.example.yaml``; see
``server.config`` for what the port serves of it).  The flags override the
file.  SIGTERM or SIGINT runs the shutdown chain (``server.shutdown``: the
warm-state snapshot with ``persistence`` on, then the flight-recorder dump)
before the services close.

``--role`` (``sidecar.role``; JAX ``server/app.py:2640-2720``):

* ``combined`` (the default): one process, HTTP and the card;
* ``sidecar``: the card only, serving renders on ``--sidecar-socket`` (a
  unix path or ``host:port``), no HTTP listener (``server.sidecar``);
* ``frontend``: HTTP only, renders over the sidecar wire to
  ``--sidecar-socket``, or, with ``fleet.enabled`` and ``fleet.sockets``,
  routed over one sidecar a member; it never touches the card;
* ``split``: spawn a ``sidecar`` child (with this command's ``--config``,
  ``--data-dir``, ``--lut-root`` and ``--device``), kept alive by the
  supervisor (``fault-tolerance.supervise``, on by default), then serve
  as its frontend;
* ``pod-worker``: a rank other than 0 of a mesh pod (``parallel.enabled``
  with its ``process-id``; JAX ``:2671-2694``): joins the process group,
  builds the global mesh (one GPU a rank), resolves ``jpeg-engine: auto``
  with the pod, and replays the leader's group dispatches
  (``parallel.serve.run_pod_follower``) until the leader announces its
  shutdown.  It answers no HTTP.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    """The config the command line describes, and the device."""
    config, device, _ = _parse(argv)
    return config, device


def _parse(argv=None):
    """The config, the device and the parsed flags."""
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
    parser.add_argument("--role",
                        choices=["combined", "frontend", "sidecar", "split",
                                 "pod-worker"],
                        help="process role of the frontend/sidecar split "
                             "(sidecar.role in the config); pod-worker: a "
                             "non-leader rank of a mesh pod (replays the "
                             "leader's group dispatches)")
    parser.add_argument("--sidecar-socket",
                        help="the sidecar's address: a unix socket path, or "
                             "host:port for TCP (a private interface: the "
                             "protocol is unauthenticated)")
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
    if args.sidecar_socket is not None:
        config.sidecar.socket = args.sidecar_socket
    if args.role == "pod-worker":
        if not config.parallel.enabled:
            parser.error("--role pod-worker requires parallel.enabled")
        if config.parallel.process_id == 0:
            # The pod channel broadcasts from rank 0: a follower there
            # would read its own zeros as a shutdown and leave the real
            # leader waiting.
            parser.error("--role pod-worker must not be process-id 0 "
                         "(process 0 is the serving leader)")
        return config, args.device, args
    if args.role is not None:
        config.sidecar.role = args.role
    if (config.sidecar.role != "combined" and not config.sidecar.socket
            and not (config.sidecar.role == "frontend"
                     and config.fleet.enabled and config.fleet.sockets)):
        # A frontend may route over a fleet of sidecars in its place.
        parser.error(f"--role {config.sidecar.role} requires "
                     f"--sidecar-socket (or a fleet.sockets list for a "
                     f"frontend fleet router)")
    return config, args.device, args


def main(argv=None) -> None:
    from .app import configure_logging, create_app, run_app

    config, device, args = _parse(argv)
    configure_logging(config)
    if args.role == "pod-worker":
        pod_worker(config, device)
        return
    if config.sidecar.role == "sidecar":
        from .sidecar import sidecar_main
        sidecar_main(config, device)
        return
    supervisor = child = None
    if config.sidecar.role == "split":
        extra = ["--device", device]
        for flag, value in (("--data-dir", args.data_dir),
                            ("--lut-root", args.lut_root)):
            if value is not None:
                extra += [flag, value]
        if config.fault_tolerance.supervise:
            from .sidecar import SidecarSupervisor
            supervisor = SidecarSupervisor.for_config(
                args.config, config.sidecar.socket, extra_args=extra,
                max_backoff_s=config.fault_tolerance.supervisor_max_backoff_s)
            supervisor.start()
        else:
            from .sidecar import spawn_sidecar
            child = spawn_sidecar(args.config, config.sidecar.socket,
                                  extra_args=extra)
        config.sidecar.role = "frontend"
    try:
        run_app(create_app(config, device), config)
    finally:
        if supervisor is not None:
            supervisor.stop()
        if child is not None:
            child.terminate()
            try:
                child.wait(timeout=15)
            except Exception:
                child.kill()


def pod_worker(config, device: str = "cuda") -> int:
    """A follower rank of a mesh pod: join, build the mesh, resolve the
    engine with the pod, replay the leader's groups; returns the number
    of groups served."""
    from ..parallel import cluster
    from ..parallel.serve import run_pod_follower

    p = config.parallel
    cluster.initialize(p.coordinator_address, p.num_processes,
                       p.process_id, device=device)
    mesh = cluster.global_mesh(chan_parallel=p.chan_parallel,
                               n_devices=p.n_devices, device=device)
    engine = config.renderer.jpeg_engine
    if engine == "auto":
        from ..utils.linkprobe import resolve_auto_engine
        engine = resolve_auto_engine(mesh.device)   # the pod's choice
    return run_pod_follower(mesh, jpeg_engine=engine)


if __name__ == "__main__":
    main()
