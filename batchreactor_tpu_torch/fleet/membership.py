"""Elastic fleet membership over a shared directory.

The fleet coordinates the way the elastic sweep does (``parallel/
multihost.py``): through files in a shared directory, with the
``resilience.heartbeat`` mtime convention as the liveness signal — no
coordinator, no gossip, nothing to fail separately.  Layout under one
``fleet_dir``::

    members/<name>.json      # registration: {"name", "url", "pid", ...}
    members/<name>.hb        # heartbeat file (resilience.Heartbeat)
    members/<name>.draining  # drain-handshake flag (empty file)
    hosts/p<pid>.metrics.json  # obs.live fleet snapshot (the elastic sweep's shape)

**Member side** (:class:`MemberRegistration`, wired by
``tools/serve.py --fleet-dir``): register atomically, beat every
``heartbeat_s``, and on each beat drop the daemon's metrics snapshot
beside it (``obs.live.write_fleet_snapshot`` — the same artifact the
elastic sweep drops, so the router's ``/metrics`` fleet merge is the
fleet-snapshot machinery verbatim).  The drain handshake is
:meth:`MemberRegistration.mark_draining` BEFORE the server closes: the
router stops routing new work to a draining member while its in-flight
requests finish — the graceful half of failover (the abrupt half is
the heartbeat aging out).

**Router side** (:func:`read_members`): scan the registrations, call
each heartbeat's age against ``dead_after_s``, and hand the live,
non-draining set to the hash ring.  A member that stops beating simply
ages out — its arc reassigns to survivors with no tombstone protocol.

stdlib-only; the router must work with wedged devices and without a device.
"""

import json
import os
import time

from ..resilience.heartbeat import Heartbeat, file_age


#: heartbeat cadence / staleness defaults — serving members beat like
#: elastic sweep processes (dead_after ~= 6 beats, the multihost rule)
DEFAULT_HEARTBEAT_S = 0.5
DEFAULT_DEAD_AFTER_S = 3.0


def _members_dir(fleet_dir):
    d = os.path.join(fleet_dir, "members")
    os.makedirs(d, exist_ok=True)
    return d


def _safe(name):
    return "".join(c if c.isalnum() or c in "-_." else "-"
                   for c in str(name))


def member_paths(fleet_dir, name):
    """(info_json, heartbeat, draining_flag) paths for ``name``."""
    base = os.path.join(_members_dir(fleet_dir), _safe(name))
    return base + ".json", base + ".hb", base + ".draining"


def obs_dir(fleet_dir):
    """``<fleet_dir>/obs`` — where the fleet's per-host trace streams
    land (``tools/serve_fleet.py --obs-dir`` default; the layout
    ``obs.stitch.load_fleet`` reads: ``router.jsonl`` + one
    ``<member>.jsonl`` per member).  Created on first ask."""
    d = os.path.join(str(fleet_dir), "obs")
    os.makedirs(d, exist_ok=True)
    return d


def member_obs_path(fleet_dir, name):
    """``<fleet_dir>/obs/<name>.jsonl`` — one host's trace stream; the
    file STEM is the host name ``obs.stitch`` joins the router's hop
    ledger against, so it must match the registration name."""
    return os.path.join(obs_dir(fleet_dir), _safe(name) + ".jsonl")


class MemberInfo(dict):
    """One member's router-side view (a dict for JSON-friendliness):
    ``name``, ``url``, ``pid``, ``age_s`` (heartbeat age), ``alive``
    (age <= dead_after), ``draining`` (drain handshake flagged).
    Routable = alive and not draining."""

    @property
    def routable(self):
        return bool(self.get("alive")) and not self.get("draining")


def read_members(fleet_dir, dead_after_s=DEFAULT_DEAD_AFTER_S):
    """All registered members, sorted by name — dead ones included
    (``alive=False``) so healthz can show who aged out; routing uses
    ``MemberInfo.routable``.  A torn registration (writer died before
    the atomic replace existed, or a disk fault) is skipped, not
    fatal."""
    d = _members_dir(fleet_dir)
    out = []
    now = time.time()
    for fname in sorted(os.listdir(d)):
        if not fname.endswith(".json"):
            continue
        try:
            with open(os.path.join(d, fname)) as f:
                info = json.load(f)
        except (OSError, ValueError):
            continue
        name = info.get("name") or fname[:-5]
        _j, hb, drain = member_paths(fleet_dir, name)
        age = file_age(hb, now=now)
        out.append(MemberInfo(
            info, age_s=(None if age is None else round(age, 3)),
            alive=(age is not None and age <= float(dead_after_s)),
            draining=os.path.exists(drain)))
    return out


class MemberRegistration:
    """Module doc: one serving daemon's membership handle.  Lifecycle
    is ``register() -> [serve] -> mark_draining() -> deregister()``;
    the heartbeat thread (and its per-beat metrics snapshot) runs in
    between.  ``registry`` (an ``obs.LiveRegistry``) is optional — no
    registry means membership without telemetry snapshots."""

    def __init__(self, fleet_dir, name, url, *, pid=None, registry=None,
                 heartbeat_s=DEFAULT_HEARTBEAT_S, meta=None):
        self.fleet_dir = str(fleet_dir)
        self.name = _safe(name)
        self.url = str(url)
        #: snapshot/registration identity — usually the OS pid, but any
        #: id works (in-process fleets, e.g. serve_bench --router, run
        #: N members under ONE pid and need distinct snapshot files)
        self.pid = os.getpid() if pid is None else pid
        self.registry = registry
        self.heartbeat_s = float(heartbeat_s)
        self.meta = dict(meta or {})
        self._paths = member_paths(self.fleet_dir, self.name)
        self._hb = None

    # ---- lifecycle ---------------------------------------------------------
    def register(self):
        """Write the registration atomically, take one synchronous
        beat (readers never see a registered-but-beatless member), and
        start the heartbeat thread."""
        info_path, hb_path, drain_path = self._paths
        try:
            os.remove(drain_path)   # re-registration clears a stale flag
        except OSError:
            pass
        info = {"name": self.name, "url": self.url, "pid": self.pid,
                "time": time.time(), **self.meta}
        tmp = f"{info_path}.tmp{self.pid}"
        with open(tmp, "w") as f:
            json.dump(info, f)
        os.replace(tmp, info_path)
        self._hb = Heartbeat(hb_path, self.heartbeat_s,
                             on_beat=self.snapshot,
                             name=f"br-fleet-member-{self.name}")
        self._hb.beat()
        self._hb.start()
        return self

    def snapshot(self):
        """Drop this member's metrics snapshot into the fleet dir (the
        obs.live artifact the router's ``/metrics`` merges); runs
        on the heartbeat thread after every beat."""
        if self.registry is None:
            return
        from ..obs.live import write_fleet_snapshot

        write_fleet_snapshot(self.fleet_dir, self.pid, self.registry)

    def mark_draining(self):
        """The drain handshake: flag this member BEFORE its server
        stops accepting, so the router routes around it while in-flight
        requests finish (new work would race the close and fail
        noisily instead of gracefully)."""
        drain_path = self._paths[2]
        with open(drain_path, "w") as f:
            f.write(str(time.time()))

    def deregister(self):
        """Stop the heartbeat and remove the registration (the metrics
        snapshot stays — the fleet merge keeps the departed member's
        counters, and its age gauge shows it stopped).  Idempotent."""
        if self._hb is not None:
            self._hb.stop()
            self._hb = None
        info_path, hb_path, _drain = self._paths
        for path in (info_path, hb_path):
            try:
                os.remove(path)
            except OSError:
                pass

    def __enter__(self):
        return self.register()

    def __exit__(self, *_exc):
        self.mark_draining()
        self.deregister()
