"""Cross-host trace stitching: fleet-wide waterfalls from per-host
JSONL streams.

Every host in a traced fleet run exports its own ``br-obs-v1`` report
(``obs.export``): the router's carries one terminal ``request_trace``
event per routed request WITH a hop ledger (``fleet/router.py`` —
member tried, hop number, send/recv wall bracket, outcome), and each
member's carries the familiar per-request stage waterfall
(``obs/trace.py``) now tagged with the inherited fleet identity
(``trace`` / ``parent_span`` / ``hop``).  This module joins them:

* :func:`load_fleet` — read every ``<host>.jsonl`` under one obs dir
  (the ``tools/serve_fleet.py --obs-dir`` layout; the file stem IS
  the host name, which for members matches the hop ledger's
  ``member`` field);
* :func:`stitch` — one stitched trace per router terminal event, each
  hop enriched with the member's stage waterfall and a **clock-skew
  correction**: the router's send/recv wall bracket must contain the
  member's ``total_s``, so ``slack = (recv - send) - member_total``
  splits evenly across the two network legs and the member's
  wall-clock start is re-based to ``send + slack/2`` (``skew_s``
  records how far the member's own clock sat from that).  A hop with
  no member event — the SIGKILLed victim of a failover — keeps its
  ledger entry with outcome ``transport``: the dead attempt is PART of
  the one trace, not a lost record.  Member events whose trace id has
  no router spine (client talked to the daemon directly) stitch into
  single-hop traces, so one renderer serves both topologies;
* :func:`merge_reports` — the fleet's counters summed and histogram
  families slot-merged (``obs.counters.hist_merge`` — the router's
  ``route_seconds`` lands beside every member's
  ``serve_stage_seconds``) into ONE ``br-obs-v1`` report
  the JAX package's ``scripts/obs_gate.py`` can check;
* :func:`render_fleet` — the slowest-N waterfall rendering
  the JAX package's ``scripts/obs_trace.py --fleet`` prints: per-hop
  attribution above,
  per-stage bars beneath, failover chains flagged.

Pure stdlib + ``obs`` siblings — stitching runs where the router runs
(no torch, wedged devices immaterial).  Port of
``batchreactor_tpu/obs/stitch.py``: reports of either package stitch
with either package's code.
"""

import os

from . import counters as C
from .export import read_jsonl
from .report import SCHEMA, hist_series_name

#: stitched-trace schema version — bump on any layout change
STITCH_VERSION = 1


# --------------------------------------------------------------------------
# loading
# --------------------------------------------------------------------------
def load_fleet(obs_dir):
    """``[(host, report)]`` from every ``*.jsonl`` under ``obs_dir``,
    sorted by host (= file stem).  Loud when the directory has no
    streams — an empty stitch is a misconfigured run, not a quiet
    success."""
    obs_dir = str(obs_dir)
    try:
        names = sorted(f for f in os.listdir(obs_dir)
                       if f.endswith(".jsonl"))
    except OSError as e:
        raise ValueError(f"fleet obs dir {obs_dir!r} is unreadable: "
                         f"{e}") from e
    if not names:
        raise ValueError(
            f"no *.jsonl trace streams under {obs_dir!r} (expected the "
            f"tools/serve_fleet.py --obs-dir layout: router.jsonl + "
            f"one <member>.jsonl per member)")
    return [(f[:-6], read_jsonl(os.path.join(obs_dir, f)))
            for f in names]


def _trace_events(reports):
    """``(host, attrs)`` for every ``request_trace`` event across the
    fleet's reports."""
    for host, report in reports:
        for e in report.get("events") or []:
            if e.get("name") == "request_trace":
                yield host, (e.get("attrs") or {})


# --------------------------------------------------------------------------
# stitching
# --------------------------------------------------------------------------
def _member_block(attrs):
    return {"stages": attrs.get("stages"),
            "segments": attrs.get("segments"),
            "total_s": attrs.get("total_s"),
            "lanes": attrs.get("lanes"),
            "parent_span": attrs.get("parent_span")}


def stitch(reports):
    """Module doc: ``[(host, report)]`` -> stitched traces sorted by
    wall start.  Router terminal events (the ones carrying ``hops``)
    are the spines; member events join their spine by
    ``(trace, hop, member-name == host)``."""
    routers = []
    members = {}      # trace id -> [(host, attrs)]
    for host, attrs in _trace_events(reports):
        if "hops" in attrs:
            routers.append((host, attrs))
        else:
            members.setdefault(attrs.get("trace"), []).append(
                (host, attrs))
    traces = []
    claimed = set()
    for rhost, attrs in routers:
        tid = attrs.get("trace")
        hops = []
        for hop in attrs.get("hops") or []:
            entry = dict(hop)
            for mhost, m in members.get(tid, ()):
                if (id(m) not in claimed
                        and m.get("hop") == hop.get("hop")
                        and mhost == hop.get("member")):
                    claimed.add(id(m))
                    entry["member_trace"] = _member_block(m)
                    send_w = hop.get("send_wall")
                    recv_w = hop.get("recv_wall")
                    total = m.get("total_s")
                    if (send_w is not None and recv_w is not None
                            and total is not None):
                        # the skew correction (module doc): the bracket
                        # contains the member's solve; split the slack
                        # evenly across the two network legs
                        slack = max(0.0, (recv_w - send_w) - total)
                        corrected = send_w + slack / 2.0
                        entry["wall_start_corrected"] = round(
                            corrected, 6)
                        mw = m.get("wall_start")
                        if mw is not None:
                            entry["skew_s"] = round(mw - corrected, 6)
                    break
            hops.append(entry)
        traces.append({
            "v": STITCH_VERSION, "trace": tid,
            "request": attrs.get("request"),
            "minted": bool(attrs.get("minted")),
            "router": rhost,
            "wall_start": attrs.get("wall_start"),
            "total_s": attrs.get("total_s"),
            "failover": bool(attrs.get("failover")),
            "tried": list(attrs.get("tried") or []),
            "host": attrs.get("host"),
            "code": attrs.get("code"),
            "failed": bool(attrs.get("failed")),
            "hops": hops})
    # router-less traces (module doc): a member event nobody claimed
    # still renders as a single-hop waterfall
    for tid in sorted(members, key=lambda t: str(t)):
        for mhost, m in members[tid]:
            if id(m) in claimed:
                continue
            traces.append({
                "v": STITCH_VERSION, "trace": tid,
                "request": m.get("request"), "minted": False,
                "router": None,
                "wall_start": m.get("wall_start"),
                "total_s": m.get("total_s"),
                "failover": False, "tried": [], "host": mhost,
                "code": None, "failed": bool(m.get("failed")),
                "hops": [{"member": mhost, "hop": m.get("hop", 0),
                          "outcome": ("failed" if m.get("failed")
                                      else "ok"),
                          "member_trace": _member_block(m)}]})
    traces.sort(key=lambda t: (t.get("wall_start") or 0.0,
                               str(t.get("request"))))
    return traces


# --------------------------------------------------------------------------
# fleet report merge
# --------------------------------------------------------------------------
def merge_reports(reports):
    """``[(host, report)]`` -> ONE ``br-obs-v1`` report: counters
    summed, histogram series slot-merged by ``(name, labels)``
    (``hist_merge`` — loud on ladder mismatch), events concatenated,
    ``meta.hosts`` naming the inputs.  The result is what
    the JAX package's ``scripts/obs_gate.py --report`` checks: the router's
    ``route_seconds`` and every member's ``serve_stage_seconds`` in
    one gate-able artifact."""
    counters = {}
    hists = {}
    events = []
    hosts = []
    for host, rep in reports:
        hosts.append(host)
        for k, v in (rep.get("counters") or {}).items():
            counters[k] = counters.get(k, 0) + v
        for name, series in (rep.get("histograms") or {}).items():
            for ser in series:
                key = hist_series_name(name, ser.get("labels"))
                cur = hists.get((name, key))
                if cur is None:
                    hists[(name, key)] = {
                        "labels": dict(ser.get("labels") or {}),
                        "le": list(ser.get("le")
                                   or C.HIST_BUCKET_EDGES),
                        **{k: ser[k] for k in ("counts", "sum",
                                               "count")}}
                else:
                    merged = C.hist_merge(cur, ser)
                    cur.update(merged)
        for e in rep.get("events") or []:
            events.append(e)
    histograms = {}
    for (name, _key), ser in sorted(hists.items(),
                                    key=lambda kv: kv[0]):
        histograms.setdefault(name, []).append(ser)
    return {"schema": SCHEMA,
            "meta": {"entry": "fleet-merge", "hosts": hosts},
            "spans": [], "events": events, "counters": counters,
            "histograms": histograms or None,
            "solver_stats": None, "compile": None}


# --------------------------------------------------------------------------
# rendering
# --------------------------------------------------------------------------
_BAR = 28


def select_traces(traces, slowest=10, threshold_ms=None):
    """Slowest-``slowest`` stitched traces (optionally only those over
    ``threshold_ms`` end-to-end) — the ``obs_trace.py`` selection rule
    applied fleet-wide."""
    pool = [t for t in traces if t.get("total_s") is not None]
    if threshold_ms is not None:
        pool = [t for t in pool
                if 1e3 * t["total_s"] >= float(threshold_ms)]
    pool.sort(key=lambda t: -t["total_s"])
    return pool[: int(slowest)]


def _fmt_ms(s):
    return f"{1e3 * s:.1f}ms"


def _stage_bars(member_trace, scale_s, indent):
    """Per-stage bars for one member waterfall, proportional to the
    TRACE total (``scale_s``) so hops of one chain compare visually."""
    from .trace import STAGE_ORDER

    lines = []
    stages = member_trace.get("stages") or {}
    segments = member_trace.get("segments") or {}
    for stage in STAGE_ORDER:
        if stage not in stages:
            continue
        off = stages[stage]
        seg = segments.get(stage, 0.0)
        lead = int(_BAR * off / scale_s) if scale_s > 0 else 0
        width = max(1, int(_BAR * seg / scale_s)) if seg else 1
        bar = " " * min(lead, _BAR - 1) + "#" * min(width,
                                                    _BAR - lead or 1)
        lines.append(f"{indent}{stage:<13} {_fmt_ms(off):>9}  "
                     f"|{bar:<{_BAR}}|")
    return lines


def render_fleet(traces, slowest=10, threshold_ms=None):
    """The human waterfall rendering (module doc): one block per
    selected trace — head line (trace id, request, end-to-end, serving
    host, failover/error flags), hop ledger with outcomes and skew,
    member stage bars."""
    picked = select_traces(traces, slowest=slowest,
                           threshold_ms=threshold_ms)
    lines = [f"fleet traces: {len(traces)} stitched, showing "
             f"{len(picked)} slowest"]
    if not picked:
        lines.append("  (no stitched traces matched)")
        return "\n".join(lines)
    for t in picked:
        flags = []
        if t.get("failover"):
            flags.append(f"FAILOVER tried={t.get('tried')}")
        if t.get("failed"):
            flags.append(f"FAILED code={t.get('code')}")
        if t.get("minted"):
            flags.append("minted")
        head = (f"trace {t.get('trace') or '-'}  "
                f"request={t.get('request')}  "
                f"{_fmt_ms(t['total_s'])}  host={t.get('host') or '-'}")
        if t.get("router") is not None:
            head += f"  router={t['router']}"
        if flags:
            head += "  [" + "; ".join(flags) + "]"
        lines.append(head)
        scale = t["total_s"] or 0.0
        for hop in t.get("hops") or []:
            extra = ""
            if "skew_s" in hop:
                extra = f"  skew={_fmt_ms(hop['skew_s'])}"
            sw, rw = hop.get("send_wall"), hop.get("recv_wall")
            if sw is not None and rw is not None:
                extra += f"  bracket={_fmt_ms(rw - sw)}"
            lines.append(f"  hop {hop.get('hop')} -> "
                         f"{hop.get('member')}  "
                         f"[{hop.get('outcome')}]{extra}")
            mt = hop.get("member_trace")
            if mt:
                lines.extend(_stage_bars(mt, scale, indent="    "))
        lines.append("")
    return "\n".join(lines).rstrip("\n")
