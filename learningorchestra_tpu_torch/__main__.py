"""Deployment CLI — port of ``learningorchestra_tpu/__main__.py``:

    python -m learningorchestra_tpu_torch serve [--port P] [--device cpu]
        REST API server on LO_TPU_API_PORT (default 80), on the card
        unless ``--device`` names another (``cpu`` for a test).  SIGINT
        stops it cleanly: exit status 0, and the lock witness's exit
        dump (``LO_TPU_WITNESS_DUMP``) is written.  On a fenced store, or
        under an ``LO_HA_PEER`` that promoted over it, it refuses with
        status 3 (``api.server.SERVE_REFUSED``).

    python -m learningorchestra_tpu_torch standby --primary HOST:PORT
            --replica DIR --port P [--primary-store DIR] [--host H]
            [--interval S] [--misses N] [--device cpu]
        Warm standby (store/ha.py): ships the primary's WALs (through the
        filesystem with ``--primary-store``, else over its
        ``/replication`` routes), probes its ``/health``, and after
        ``--misses`` failed probes promotes the replica and serves the
        full API on ``--port``, on the card unless ``--device`` names
        another.  The torch import, the CUDA context and the kernel
        libraries are paid before promotion.

    python -m learningorchestra_tpu_torch coordinator | agent
        Parse as in the JAX package and exit with status 2 and one line
        naming the ROADMAP item that ports them: the multi-host task
        coordinator and its agents (A.9 part 2).
"""

from __future__ import annotations

import argparse
import os
import sys

#: Subcommand -> the ROADMAP item that ports it.
UNPORTED = {
    "coordinator": "ROADMAP A.9 part 2 (parallel/coordinator.py)",
    "agent": "ROADMAP A.9 part 2 (parallel/coordinator.py, "
             "parallel/launch.py)",
}


def _cmd_serve(args) -> int:
    if args.port:
        # Before the config is built: from_env reads it.  An argv port
        # also lets a supervisor tell the processes apart.
        os.environ["LO_TPU_API_PORT"] = str(args.port)
    from learningorchestra_tpu_torch.api.server import serve

    try:
        return serve(device=args.device)
    except KeyboardInterrupt:
        return 0


def _cmd_standby(args) -> int:
    from learningorchestra_tpu_torch.store.ha import run_standby

    try:
        run_standby(args.primary, args.primary_store, args.replica,
                    args.port, check_interval=args.interval,
                    max_misses=args.misses, host=args.host,
                    device=args.device)
    except KeyboardInterrupt:
        pass
    return 0


def _cmd_unported(args) -> int:
    print(f"learningorchestra_tpu_torch {args.command}: not ported yet — "
          f"{UNPORTED[args.command]}", file=sys.stderr)
    return 2


def build_parser() -> argparse.ArgumentParser:
    """The JAX package's subcommands and flags, plus ``serve --device``."""
    parser = argparse.ArgumentParser(prog="learningorchestra_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    serve_p = sub.add_parser("serve", help="run the REST API server")
    serve_p.add_argument(
        "--port", type=int, default=None,
        help="overrides LO_TPU_API_PORT",
    )
    serve_p.add_argument(
        "--device", default="cuda",
        help="device the estimators run on (default cuda; cpu for tests)",
    )

    coord = sub.add_parser("coordinator", help="run the control plane")
    coord.add_argument("--host", default="0.0.0.0")
    coord.add_argument("--port", type=int, default=7070)

    agent = sub.add_parser("agent", help="run a per-host worker agent")
    agent.add_argument("--coordinator", required=True,
                       help="coordinator HOST:PORT")
    agent.add_argument("--id", default=None)
    agent.add_argument("--capacity", type=int, default=1)

    standby = sub.add_parser(
        "standby", help="warm standby with automatic promotion"
    )
    standby.add_argument("--primary", required=True,
                         help="primary API HOST:PORT to health-check")
    standby.add_argument("--primary-store", default=None,
                         help="primary's store directory (WAL source) "
                              "when a mount is shared; omit to ship WALs "
                              "over the primary's /replication routes")
    standby.add_argument("--replica", required=True,
                         help="local replica directory")
    standby.add_argument("--port", type=int, required=True,
                         help="port to serve on after promotion")
    standby.add_argument("--host", default="0.0.0.0")
    standby.add_argument("--interval", type=float, default=0.5,
                         help="seconds between sync+health probes")
    standby.add_argument("--misses", type=int, default=4,
                         help="consecutive failed probes before takeover")
    standby.add_argument(
        "--device", default="cuda",
        help="device the promoted server runs on (default cuda; cpu for "
             "tests)",
    )
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "serve":
        return _cmd_serve(args)
    if args.command == "standby":
        return _cmd_standby(args)
    return _cmd_unported(args)


if __name__ == "__main__":
    sys.exit(main())
