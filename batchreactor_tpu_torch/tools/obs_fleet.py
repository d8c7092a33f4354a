"""Merged fleet telemetry view over a shared checkpoint directory (the
port's ``scripts/obs_fleet.py``).

Each ``elastic_checkpointed_sweep`` process drops periodic metric
snapshots beside its heartbeat (``<ckpt_dir>/hosts/p<id>.metrics.json``
— ``obs.live.write_fleet_snapshot``); this CLI reads them all and
renders the pod-level picture: per-host counters/gauges, snapshot ages
(a stale snapshot = a slow, dead, or partitioned host), and the merged
reduction (counters summed, gauges max-reduced — docs/observability.md
"Fleet view").

  # human-readable table
  python -m batchreactor_tpu_torch.tools.obs_fleet CKPT_DIR

  # Prometheus text exposition (what /metrics appends with fleet_dir=)
  python -m batchreactor_tpu_torch.tools.obs_fleet CKPT_DIR --prom

  # serve the merged view on a port (standalone fleet endpoint — no
  # sweep process needed; re-reads the snapshots on every scrape)
  python -m batchreactor_tpu_torch.tools.obs_fleet CKPT_DIR --serve 9109

It touches no device: reading JSON snapshots must work on a host whose
devices are wedged.
"""

import argparse
import json
import sys
import time

from batchreactor_tpu_torch.obs.counters import occupancy
from batchreactor_tpu_torch.obs.live import (LiveRegistry, MetricsServer,
                                             fleet_prometheus, merge_fleet,
                                             read_fleet_snapshots)


def render_fleet(snaps):
    merged = merge_fleet(snaps)
    lines = [f"fleet: {merged['hosts']} host(s) with snapshots"]
    now = time.time()
    for s in snaps:
        age = now - float(s.get("time", 0))
        lines.append(f"  p{s.get('pid', '?')}: snapshot age {age:.1f}s")
        for k, v in sorted((s.get("gauges") or {}).items()):
            lines.append(f"    gauge {k}: {v}")
        for k, v in sorted((s.get("counters") or {}).items()):
            lines.append(f"    counter {k}: {v}")
    lines.append("merged (counters summed, gauges max-reduced):")
    for k, v in sorted(merged["counters"].items()):
        lines.append(f"  counter {k}: {v}")
    for k, v in sorted(merged["gauges"].items()):
        lines.append(f"  gauge {k}: {v}")
    occ = occupancy(merged["counters"])
    if occ is not None:
        lines.append(f"  occupancy: {occ:.4f} (fleet-wide)")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="merged fleet telemetry over a shared checkpoint dir")
    ap.add_argument("ckpt_dir", help="the elastic sweep's shared "
                                     "checkpoint directory")
    ap.add_argument("--prom", action="store_true",
                    help="print the Prometheus fleet exposition")
    ap.add_argument("--json", action="store_true",
                    help="print the merged reduction as JSON")
    ap.add_argument("--serve", type=int, metavar="PORT",
                    help="serve /metrics (fleet view) + /healthz on PORT "
                         "until interrupted (0 = ephemeral)")
    args = ap.parse_args(argv)

    if args.serve is not None:
        # a registry with no recorder: /metrics is the fleet section
        # (re-read per scrape) plus the uptime gauge
        reg = LiveRegistry(meta={"entry": "obs_fleet"},
                           fleet_dir=args.ckpt_dir)
        with MetricsServer(reg, port=args.serve) as srv:
            print(f"serving fleet view of {args.ckpt_dir} on {srv.url} "
                  f"(ctrl-C to stop)", file=sys.stderr)
            try:
                while True:
                    time.sleep(3600)
            except KeyboardInterrupt:
                return 0

    snaps = read_fleet_snapshots(args.ckpt_dir)
    if not snaps:
        print(f"no metric snapshots under {args.ckpt_dir}/hosts "
              f"(is an elastic sweep with a recorder running?)",
              file=sys.stderr)
        return 1
    if args.prom:
        sys.stdout.write(fleet_prometheus(snaps))
    elif args.json:
        print(json.dumps(merge_fleet(snaps), indent=1, sort_keys=True))
    else:
        print(render_fleet(snaps))
    return 0


if __name__ == "__main__":
    sys.exit(main())
