"""Cluster-log tail: dump or follow the monitor's merged event journal.

The operator face of the event layer (the `ceph log last` / `ceph -W
<channel>` role): query the mon admin socket's ``dump_cluster_log``
verb, render events one per line, and in ``--follow`` mode poll the
``last_seq`` cursor so only NEW events print — a tail, not a replay.

CLI::

    python -m ceph_tpu_torch.tools.event_tool --asok /tmp/asok/mon.0.asok
    python -m ceph_tpu_torch.tools.event_tool --asok ... --channel recovery -f
    python -m ceph_tpu_torch.tools.event_tool --admin-dir /tmp/asok \
        --daemon mon.0 -f     # resolved via the shared vstart resolver

The library half (``fetch_events`` / ``format_event`` / ``tail``) is
what the tests and any scripted consumer drive directly.
"""

from __future__ import annotations

import argparse
import sys
import time

from ..utils.admin_socket import admin_request


def fetch_events(asok: str, since: int = 0,
                 channel: str | None = None,
                 max_events: int = 0) -> tuple[list[dict], int]:
    """One ``dump_cluster_log`` round-trip: (events newer than
    ``since``, the new follow cursor)."""
    kw = {"since": since}
    if channel:
        kw["channel"] = channel
    if max_events:
        kw["max"] = max_events
    result = admin_request(asok, "dump_cluster_log", **kw)
    # the mon admin socket serves _run_command verbs as (errno, data)
    if isinstance(result, list) and len(result) == 2 \
            and isinstance(result[0], int):
        if result[0] != 0:
            raise RuntimeError(f"dump_cluster_log failed: {result[1]}")
        result = result[1]
    return result["events"], int(result["last_seq"])


def format_event(ev: dict) -> str:
    """One journal line: time, daemon, [channel] SEVERITY, message,
    then the structured fields as k=v (skipping ones the message
    already carries poorly — none; fields are the machine face)."""
    t = time.strftime("%H:%M:%S", time.localtime(ev.get("ts", 0)))
    ms = int((ev.get("ts", 0) % 1) * 1000)
    sev = ev.get("severity", "info").upper()
    fields = " ".join(f"{k}={v}" for k, v in
                      sorted((ev.get("fields") or {}).items()))
    return (f"{t}.{ms:03d} {ev.get('daemon', '?'):<10} "
            f"[{ev.get('channel', '?')}] {sev:<5} "
            f"{ev.get('message', '')}" + (f"  ({fields})" if fields
                                          else ""))


def tail(asok: str, channel: str | None = None, follow: bool = False,
         interval: float = 0.5, max_polls: int | None = None,
         out=print) -> int:
    """Print the ring (newest last), then — with ``follow`` — poll the
    seq cursor for new events until interrupted (or ``max_polls``
    fetches, the testability bound).  Returns events printed."""
    printed = 0
    events, cursor = fetch_events(asok, channel=channel)
    for ev in events:
        out(format_event(ev))
        printed += 1
    polls = 0
    while follow and (max_polls is None or polls < max_polls):
        time.sleep(interval)
        polls += 1
        try:
            events, cursor = fetch_events(asok, since=cursor,
                                          channel=channel)
        except (OSError, RuntimeError):
            continue  # mon briefly away (election/restart): keep tailing
        for ev in events:
            out(format_event(ev))
            printed += 1
    return printed


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="dump or follow the monitor's merged cluster "
                    "event log (`ceph -W` role)")
    p.add_argument("--asok", default=None,
                   help="mon admin socket (mon.N.asok)")
    p.add_argument("--admin-dir", default=None,
                   help="cluster admin-socket directory; combined "
                        "with --daemon through the SHARED vstart "
                        "resolver instead of hand-building the path")
    p.add_argument("--daemon", default="mon.0",
                   help="daemon name under --admin-dir (default "
                        "mon.0 — only the mon serves "
                        "dump_cluster_log)")
    p.add_argument("--channel", default=None,
                   help="filter to one channel (pg, recovery, scrub, "
                        "batch, health, osdmap, cluster)")
    p.add_argument("-f", "--follow", action="store_true",
                   help="keep polling for new events (ceph -W)")
    p.add_argument("--interval", type=float, default=0.5,
                   help="follow-mode poll interval seconds")
    p.add_argument("--max-polls", type=int, default=None,
                   help="stop following after N polls (scripting/tests)")
    args = p.parse_args(argv)
    asok = args.asok
    if asok is None:
        if args.admin_dir is None:
            p.error("need --asok or --admin-dir")
        from ..utils.admin_socket import asok_path
        asok = asok_path(args.admin_dir, args.daemon)
    try:
        tail(asok, channel=args.channel, follow=args.follow,
             interval=args.interval, max_polls=args.max_polls)
    except KeyboardInterrupt:
        return 0
    except (OSError, RuntimeError) as e:
        print(f"event_tool: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
