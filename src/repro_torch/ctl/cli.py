"""``repro-ctl`` — command-line client (and launcher) for the control
plane; ``python -m repro_torch.ctl`` takes the subcommands and flags of
``python -m repro.ctl``.

::

    repro-ctl start  --store jobs.sqlite --socket ctl.sock [engine flags]
    repro-ctl submit --name res50 --iters 200 --iter-time 0.5 \\
                     --persistent-mb 400 --ephemeral-mb 2200
    repro-ctl status [JOB_ID] [--json]
    repro-ctl cancel JOB_ID
    repro-ctl pause  JOB_ID
    repro-ctl resume JOB_ID
    repro-ctl drain  [--wait --timeout 60]
    repro-ctl shutdown
    repro-ctl ping

``start`` runs the daemon in the foreground (supervise it with whatever
you already use — systemd, a test harness, ``&``). Everything else is a
one-shot request over the daemon's unix socket; ``--socket`` (or
``$REPRO_CTL_SOCKET``) says where.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from repro_torch.core.types import MB
from repro_torch.ctl.daemon import CtlClient, CtlDaemon


def _default_socket() -> str:
    return os.environ.get("REPRO_CTL_SOCKET", "repro-ctl.sock")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repro-ctl", description="Salus-repro control plane client/daemon"
    )
    p.add_argument(
        "--socket",
        default=_default_socket(),
        help="daemon unix socket path (default $REPRO_CTL_SOCKET or ./repro-ctl.sock)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    st = sub.add_parser("start", help="run the daemon in the foreground")
    st.add_argument("--store", required=True, help="SQLite job store path")
    st.add_argument("--n-devices", type=int, default=1)
    st.add_argument("--capacity-gb", type=float, default=8.0)
    st.add_argument("--policy", default="fifo")
    st.add_argument("--strategy", default="least_loaded")
    st.add_argument("--paging", action="store_true")
    st.add_argument("--page-bandwidth-gbs", type=float, default=12.0)
    st.add_argument(
        "--epoch",
        type=float,
        default=60.0,
        help="rebalance/commit interval in scheduling-clock seconds",
    )
    st.add_argument(
        "--rebalance-mode",
        default="none",
        choices=["none", "consolidate", "rebalance"],
    )
    st.add_argument(
        "--epoch-sleep",
        type=float,
        default=0.0,
        help="wall seconds slept per epoch (paces virtual fleets for chaos tests)",
    )

    sb = sub.add_parser("submit", help="submit a trace job")
    sb.add_argument("--name", required=True)
    sb.add_argument("--iters", type=int, required=True)
    sb.add_argument("--iter-time", type=float, required=True)
    sb.add_argument("--persistent-mb", type=float, required=True)
    sb.add_argument("--ephemeral-mb", type=float, required=True)
    sb.add_argument("--utilization", type=float, default=1.0)
    sb.add_argument("--arrival", type=float, default=0.0)
    sb.add_argument("--kind", default="train", choices=["train", "inference"])
    sb.add_argument("--priority", type=int, default=None)
    sb.add_argument(
        "--hold",
        action="store_true",
        help="record the job PAUSED; it only runs after an explicit resume",
    )

    ss = sub.add_parser("status", help="daemon + job status")
    ss.add_argument("job_id", nargs="?", type=int, default=None)
    ss.add_argument("--json", action="store_true", dest="as_json")

    for name, hlp in (
        ("cancel", "terminally cancel a job"),
        ("pause", "evict a job keeping its progress"),
        ("resume", "requeue a paused job"),
    ):
        sp = sub.add_parser(name, help=hlp)
        sp.add_argument("job_id", type=int)

    dr = sub.add_parser("drain", help="refuse new submissions; optionally wait")
    dr.add_argument("--wait", action="store_true")
    dr.add_argument("--timeout", type=float, default=60.0)

    sub.add_parser("shutdown", help="stop the daemon")
    sub.add_parser("ping", help="daemon liveness + job counts")
    return p


def _cmd_start(args: argparse.Namespace) -> int:
    daemon = CtlDaemon(
        store=args.store,
        socket_path=args.socket,
        n_devices=args.n_devices,
        capacity=int(args.capacity_gb * 1024 * MB),
        policy=args.policy,
        strategy=args.strategy,
        paging=args.paging,
        page_bandwidth=args.page_bandwidth_gbs * 1024 * MB,
        epoch=args.epoch,
        rebalance_mode=args.rebalance_mode,
        epoch_sleep=args.epoch_sleep,
    )
    print(
        f"repro-ctl daemon: store={args.store} socket={args.socket} "
        f"devices={args.n_devices} policy={args.policy}",
        flush=True,
    )
    try:
        daemon.serve()
    except KeyboardInterrupt:
        daemon.stop()
    return 0


def _print_status(resp: dict, as_json: bool) -> None:
    if as_json:
        print(json.dumps(resp, indent=2, sort_keys=True))
        return
    if "job" in resp:
        j = resp["job"]
        print(
            f"job {j['job_id']} {j['name']}: {j['state']} "
            f"({j['iterations_done']}/{j['n_iters']} iters)"
        )
        for t in j.get("transitions", []):
            src = t["src"] or "-"
            print(f"  {src:>10} -> {t['dst']:<10} {t['reason']}")
        return
    print(
        f"fleet_runs={resp['fleet_runs']} epochs={resp['epochs']} "
        f"decisions={resp['decisions']} draining={resp['draining']}"
    )
    for j in resp["jobs"]:
        print(
            f"  {j['job_id']:>4} {j['name']:<20} {j['state']:<10} "
            f"{j['iterations_done']:>6}/{j['n_iters']}"
        )


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "start":
        return _cmd_start(args)
    client = CtlClient(args.socket)
    if args.command == "submit":
        spec = {
            "name": args.name,
            "n_iters": args.iters,
            "iter_time": args.iter_time,
            "persistent": int(args.persistent_mb * MB),
            "ephemeral": int(args.ephemeral_mb * MB),
            "utilization": args.utilization,
            "arrival_time": args.arrival,
            "kind": args.kind,
            "priority": args.priority,
        }
        resp = client.request("submit", spec=spec, hold=args.hold)
        print(resp["job_id"])
    elif args.command == "status":
        resp = client.request("status", job_id=args.job_id)
        _print_status(resp, args.as_json)
    elif args.command in ("cancel", "pause", "resume"):
        resp = client.request(args.command, job_id=args.job_id)
        note = " (at next epoch boundary)" if resp.get("pending") else ""
        print(f"{args.command} job {args.job_id}: ok{note}")
    elif args.command == "drain":
        resp = client.request("drain", wait=args.wait, timeout=args.timeout)
        print(f"draining (quiet={resp['quiet']})")
    elif args.command == "shutdown":
        client.request("shutdown")
        print("daemon stopping")
    elif args.command == "ping":
        resp = client.request("ping")
        print(json.dumps(resp, indent=2, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
