"""fleet/ of the port: the consistent-hash ring, membership, the upload
journal and the router, held to the JAX package's ``batchreactor_tpu/fleet``.

* **parity** — ``HashRing``, ``request_key`` and ``canonical_key`` give
  the reference's owners and preference lists for the same members and
  keys (so a fleet mixing both packages routes alike), and member files
  and the upload journal written by either package are read by the other;
* **the reference's own tiers, run against the port** — ring properties,
  membership, the router over fake members (stdlib HTTP, no solver) and
  its tracing, and the fleet snapshot merge;
* **one live fleet** of two CPU daemons of the port behind the port's
  router, failing over when the serving member dies.
"""

import http.server
import json
import os
import random
import threading
import time

import pytest
import torch

from batchreactor_tpu import fleet as jfleet
from batchreactor_tpu_torch.fleet import (DEFAULT_VNODES, FleetRouter,
                                          HashRing, MemberRegistration,
                                          UploadJournal, canonical_key,
                                          member_paths, read_members,
                                          request_key)
from batchreactor_tpu_torch.serving import schema

torch.set_num_threads(1)


# --------------------------------------------------------------------------
# parity with the JAX package
# --------------------------------------------------------------------------
def _random_keys(rng, n):
    mechs = [None, "gri", "user-mech-7", "h2o2\x1fodd"]
    return [(rng.choice(mechs), rng.choice([1e-5, 2e-4, 0.05, 1, None]),
             rng.choice([None, 1e-6, 1e-8]), rng.choice([None, 1e-10]),
             rng.choice([None, "adiabatic_v", "adiabatic_p"]))
            for _ in range(n)]


@pytest.mark.parametrize("n_members,vnodes", [(1, 64), (2, 64), (5, 64),
                                              (3, 7)])
def test_ring_routes_like_the_reference(n_members, vnodes):
    rng = random.Random(n_members * 31 + vnodes)
    members = [f"m{rng.randrange(10**6)}" for _ in range(n_members)]
    a = HashRing(members, vnodes=vnodes)
    b = jfleet.HashRing(list(reversed(members)), vnodes=vnodes)
    assert a.members() == b.members()
    assert a._points == b._points
    for key in _random_keys(rng, 200) + [f"sample:{i}" for i in range(20)]:
        assert a.route(key) == b.route(key)
        assert a.preference(key) == b.preference(key)
        assert a.preference(key, n=1) == b.preference(key, n=1)
    assert a.arc_share(512) == b.arc_share(512)


def test_request_and_canonical_keys_match_the_reference():
    objs = [{"t1": 1e-4, "mech": "gri"}, {"t1": 5e-5, "rtol": 1e-7,
                                          "atol": 1e-12,
                                          "energy": "adiabatic_v"},
            {}, "not a dict", None, {"t1": 0.1 + 0.2}]
    for obj in objs:
        assert request_key(obj) == jfleet.request_key(obj)
        key = request_key(obj)
        assert canonical_key(key) == jfleet.canonical_key(key)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_member_files_are_read_by_either_package(tmp_path, writer):
    d = str(tmp_path)
    Reg = (jfleet.MemberRegistration if writer == "jax"
           else MemberRegistration)
    reg = Reg(d, "m1", "http://127.0.0.1:1234", pid=4242, heartbeat_s=0.05,
              meta={"device": "cpu"})
    reg.register()
    try:
        reg.mark_draining()
        for read in (read_members, jfleet.read_members):
            (m,) = read(d, dead_after_s=5.0)
            assert m["name"] == "m1" and m["pid"] == 4242
            assert m["url"] == "http://127.0.0.1:1234"
            assert m["device"] == "cpu"
            assert m["alive"] and m["draining"] and not m.routable
        assert member_paths(d, "m1") == jfleet.member_paths(d, "m1")
    finally:
        reg.deregister()
    assert read_members(d) == jfleet.read_members(d) == []


def test_upload_journal_matches_the_reference():
    ups = [{"id": "a", "mech": "1", "therm": "t", "warm": True},
           {"id": "b", "mech": "2", "therm": "t", "warm": False},
           {"id": "a", "mech": "3", "therm": "t", "warm": True}]
    j, r = UploadJournal(), jfleet.UploadJournal()
    for u in ups:
        j.record(dict(u))
        r.record(dict(u))
    assert j.ids() == r.ids() == ["a", "b"]
    assert j.replay() == r.replay()
    # a journal replay feeds either package's upload validator alike
    from batchreactor_tpu.serving import schema as jschema

    for u in j.replay():
        assert schema.validate_upload(u) == jschema.validate_upload(u)


# --------------------------------------------------------------------------
# the reference's tiers, run against the port
# --------------------------------------------------------------------------
def _keys(n):
    return [(f"mech{i % 3}", 1e-5 * (1 + i), None, None, None)
            for i in range(n)]


class TestHashRing:
    def test_restart_determinism(self):
        """Same member set => identical routes from two independently
        built rings (sha256, not python's per-process-salted hash) —
        the members' warm state outlives a router, so a restarted router
        must send each key back to the member already holding it warm."""
        members = [f"m{i}" for i in range(5)]
        a = HashRing(members)
        b = HashRing(reversed(members))     # order must not matter
        for key in _keys(300):
            assert a.route(key) == b.route(key)
            assert a.preference(key) == b.preference(key)

    def test_bounded_churn_on_removal(self):
        """Removing one member moves ONLY the keys it owned, and each
        moves to its old failover target (preference[1]) — a death
        re-assigns arcs, it does not reshuffle the fleet."""
        ring = HashRing([f"m{i}" for i in range(5)])
        gone = "m2"
        small = ring.with_members(set(ring.members()) - {gone})
        moved = 0
        for key in _keys(400):
            before = ring.preference(key)
            after = small.route(key)
            if before[0] == gone:
                moved += 1
                assert after == before[1]
            else:
                assert after == before[0]
        assert moved > 0    # the sample actually exercised the arcs

    def test_bounded_churn_on_join(self):
        """Adding a member moves keys only ONTO the joiner — nobody
        else's warm state is disturbed."""
        ring = HashRing(["m0", "m1", "m2"])
        grown = ring.with_members(list(ring.members()) + ["m3"])
        joined = 0
        for key in _keys(400):
            before, after = ring.route(key), grown.route(key)
            if after != before:
                joined += 1
                assert after == "m3"
        assert 0 < joined < 400     # some keys moved, most stayed

    def test_pack_key_affinity_and_spread(self):
        """One routing key always lands on one member; a realistic
        key spread (3 mechanisms x many horizons) reaches EVERY member
        of a small fleet (64 vnodes keep arcs even enough)."""
        ring = HashRing(["m0", "m1", "m2", "m3"])
        hit = set()
        for key in _keys(60):
            owner = ring.route(key)
            assert all(ring.route(key) == owner for _ in range(3))
            hit.add(owner)
        assert hit == set(ring.members())
        shares = ring.arc_share(samples=2048)
        assert all(0.05 < v < 0.60 for v in shares.values()), shares

    def test_preference_is_distinct_and_complete(self):
        ring = HashRing(["a", "b", "c"])
        for key in _keys(50):
            prefs = ring.preference(key)
            assert sorted(prefs) == ["a", "b", "c"]
            assert prefs[0] == ring.route(key)
        assert ring.preference(_keys(1)[0], n=2) == ring.preference(
            _keys(1)[0])[:2]

    def test_empty_and_vnodes(self):
        assert HashRing(()).route(("k",)) is None
        assert HashRing(()).preference(("k",)) == []
        assert HashRing(["m"], vnodes=4).vnodes == 4
        assert HashRing(["m"]).vnodes == DEFAULT_VNODES

    def test_request_key_peek(self):
        assert request_key({"t1": 1e-4, "mech": "gri"}) == (
            "gri", 1e-4, None, None, None)
        assert request_key("not a dict") == ("invalid",)


# --------------------------------------------------------------------------
# membership
# --------------------------------------------------------------------------
class TestMembership:
    def test_register_read_roundtrip(self, tmp_path):
        d = str(tmp_path)
        reg = MemberRegistration(d, "m1", "http://127.0.0.1:1234",
                                 pid=4242, heartbeat_s=0.05)
        with reg:
            members = read_members(d, dead_after_s=5.0)
            assert [m["name"] for m in members] == ["m1"]
            m = members[0]
            assert m["url"] == "http://127.0.0.1:1234"
            assert m["pid"] == 4242
            assert m["alive"] and not m["draining"] and m.routable
        # context exit = drain handshake + deregister
        assert read_members(d, dead_after_s=5.0) == []

    def test_heartbeat_age_out(self, tmp_path):
        d = str(tmp_path)
        reg = MemberRegistration(d, "m1", "u", heartbeat_s=0.02)
        reg.register()
        assert read_members(d, dead_after_s=2.0)[0].routable
        reg._hb.stop()      # the daemon wedged/died: beats stop
        time.sleep(0.25)
        m = read_members(d, dead_after_s=0.1)[0]
        assert not m["alive"] and not m.routable
        assert m["age_s"] >= 0.1
        reg.deregister()

    def test_drain_flag_and_reregistration(self, tmp_path):
        d = str(tmp_path)
        reg = MemberRegistration(d, "m1", "u", heartbeat_s=0.05)
        reg.register()
        reg.mark_draining()
        m = read_members(d, dead_after_s=5.0)[0]
        assert m["draining"] and m["alive"] and not m.routable
        reg.deregister()
        # the drain flag outlives deregistration on purpose (metrics
        # snapshots do too); a RE-registration must clear it
        assert os.path.exists(member_paths(d, "m1")[2])
        reg2 = MemberRegistration(d, "m1", "u2", heartbeat_s=0.05)
        reg2.register()
        assert read_members(d, dead_after_s=5.0)[0].routable
        reg2.deregister()

    def test_torn_registration_skipped(self, tmp_path):
        d = str(tmp_path)
        os.makedirs(os.path.join(d, "members"), exist_ok=True)
        with open(os.path.join(d, "members", "bad.json"), "w") as f:
            f.write("{not json")
        assert read_members(d) == []


class TestUploadJournal:
    def test_latest_per_id_in_first_accepted_order(self):
        j = UploadJournal()
        j.record({"id": "a", "mech": "1", "therm": "t", "warm": True})
        j.record({"id": "b", "mech": "2", "therm": "t", "warm": True})
        j.record({"id": "a", "mech": "3", "therm": "t", "warm": True})
        assert j.ids() == ["a", "b"]
        assert [u["mech"] for u in j.replay()] == ["3", "2"]


# --------------------------------------------------------------------------
# router over fake members (no jax, no solver — semantics only)
# --------------------------------------------------------------------------
class FakeMember:
    """A canned member daemon: real stdlib HTTP + real membership, no
    solver.  ``/solve`` answers ok (recording the request id) unless
    scripted with ``error=(status, code)``; ``/mechanism`` records the
    upload and answers an admission receipt.  ``kill_http()`` tears the
    server down ABRUPTLY while the heartbeat keeps beating — the
    pre-age-out death window the failover path exists for."""

    def __init__(self, fleet_dir, name, error=None, heartbeat_s=0.05):
        self.name = name
        self.error = error
        self.solved = []
        self.requests = []      # full /solve bodies, as received
        self.uploads = []
        outer = self

        class _H(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                obj = json.loads(self.rfile.read(n).decode())
                if self.path == "/mechanism":
                    outer.uploads.append(obj["id"])
                    status, body = 200, schema.ok_response(
                        obj["id"], {"fingerprint": f"fp-{obj['mech']}"})
                elif outer.error is not None:
                    outer.requests.append(obj)
                    status, code = outer.error
                    body = schema.error_response(obj.get("id"), code,
                                                 "canned")
                else:
                    outer.requests.append(obj)
                    outer.solved.append(obj.get("id"))
                    status, body = 200, schema.ok_response(
                        obj.get("id"), {"served_by": outer.name})
                payload = (json.dumps(body) + "\n").encode()
                self.send_response(status)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, *_a):
                pass

        self._server = http.server.ThreadingHTTPServer(
            ("127.0.0.1", 0), _H)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()
        self.url = f"http://127.0.0.1:{self._server.server_address[1]}"
        self.membership = MemberRegistration(
            fleet_dir, name, self.url, pid=f"fake-{name}",
            heartbeat_s=heartbeat_s).register()

    def kill_http(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._thread.join()
            self._server = None

    def close(self):
        self.kill_http()
        self.membership.deregister()


@pytest.fixture()
def fleet_dir(tmp_path):
    return str(tmp_path / "fleet")


def _router(fleet_dir, **kw):
    # refresh_s=0: tests mutate membership and expect the next call to
    # see it (the TTL is a production knob, not a semantics one)
    kw.setdefault("refresh_s", 0.0)
    kw.setdefault("dead_after_s", 30.0)
    kw.setdefault("request_timeout", 5.0)
    return FleetRouter(fleet_dir, **kw)


def _solve_req(i=0, t1=1e-4):
    return {"id": f"r{i}", "T": [1200.0], "X": {"H2": 1.0}, "t1": t1}


class TestRouterSemantics:
    def test_key_affinity_across_members(self, fleet_dir):
        a = FakeMember(fleet_dir, "a")
        b = FakeMember(fleet_dir, "b")
        try:
            router = _router(fleet_dir)
            # one key -> one member, every time
            for i in range(6):
                status, resp = router.solve(_solve_req(i, t1=1e-4))
                assert status == 200 and resp["status"] == "ok"
                assert not resp["router"]["failover"]
            hosts = {resp["router"]["host"]}
            assert len(a.solved or b.solved) == 6
            # a t1 spread reaches both members (the serve_bench
            # --t1-choices rationale)
            for i in range(40):
                _s, r = router.solve(_solve_req(100 + i, t1=1e-6 * (i + 1)))
                hosts.add(r["router"]["host"])
            assert hosts == {"a", "b"}
        finally:
            a.close()
            b.close()

    def test_failover_on_transport_death(self, fleet_dir):
        a = FakeMember(fleet_dir, "a")
        b = FakeMember(fleet_dir, "b")
        try:
            router = _router(fleet_dir)
            _s, first = router.solve(_solve_req(0))
            primary = first["router"]["host"]
            dead, survivor = ((a, b) if primary == "a" else (b, a))
            # abrupt death: HTTP gone, heartbeat still fresh (the
            # pre-age-out window) — the router must fail over, answer
            # exactly once, and say so in the provenance
            dead.kill_http()
            status, resp = router.solve(_solve_req(1))
            assert status == 200 and resp["status"] == "ok"
            assert resp["served_by"] == survivor.name
            assert resp["router"] == {"host": survivor.name,
                                      "attempts": 2, "failover": True,
                                      "tried": [dead.name]}
            # the dead member is now suspect: the next forward skips it
            status, resp = router.solve(_solve_req(2))
            assert status == 200
            assert resp["router"]["failover"] is False
            assert resp["router"]["host"] == survivor.name
            counters = router.recorder.snapshot()[2]
            assert counters["route_failovers"] == 1
            assert counters["route_requests"] == 3
            assert router.healthz()["router"]["suspects"] == [dead.name]
        finally:
            a.close()
            b.close()

    def test_draining_response_fails_over(self, fleet_dir):
        a = FakeMember(fleet_dir, "a", error=(503, "draining"))
        b = FakeMember(fleet_dir, "b", error=(503, "draining"))
        try:
            router = _router(fleet_dir)
            _s, first = router.solve(_solve_req(0))
            assert first["status"] == "error"    # both draining: honest 503
            primary = ((first.get("error") or {}).get("message"))
            assert "failed" in primary
            # revive one: the drain-window race resolves to the survivor
            b.error = None
            status, resp = router.solve(_solve_req(1))
            assert status == 200 and resp["served_by"] == "b"
            if resp["router"]["host"] != resp.get("served_by"):
                pytest.fail(f"provenance mismatch: {resp['router']}")
        finally:
            a.close()
            b.close()

    def test_honest_errors_pass_through_without_retry(self, fleet_dir):
        a = FakeMember(fleet_dir, "a", error=(503, "overloaded"))
        b = FakeMember(fleet_dir, "b", error=(503, "overloaded"))
        try:
            router = _router(fleet_dir)
            status, resp = router.solve(_solve_req(0))
            # overloaded is the member's honest backpressure — retrying
            # it elsewhere would double-serve a request the client will
            # retry itself; it passes through with attempt count 1
            assert status == 503
            assert resp["error"]["code"] == "overloaded"
            assert resp["router"]["attempts"] == 1
            assert not resp["router"]["failover"]
            assert a.solved == b.solved == []
            counters = router.recorder.snapshot()[2]
            assert counters["route_upstream_errors"] == 1
            assert "route_failovers" not in counters
        finally:
            a.close()
            b.close()

    def test_empty_fleet_503(self, fleet_dir):
        router = _router(fleet_dir)
        status, resp = router.solve(_solve_req(0))
        assert status == 503
        assert resp["error"]["code"] == "internal"
        assert "no routable fleet members" in resp["error"]["message"]
        counters = router.recorder.snapshot()[2]
        assert counters["route_no_members"] == 1

    def test_upload_replicates_to_all_members(self, fleet_dir):
        a = FakeMember(fleet_dir, "a")
        b = FakeMember(fleet_dir, "b")
        try:
            router = _router(fleet_dir)
            up = {"id": "gri", "mech": "MECHTEXT", "therm": "THERMTEXT"}
            status, resp = router.upload(dict(up))
            assert status == 200 and resp["status"] == "ok"
            assert resp["replicated"] == ["a", "b"]
            assert resp["failed"] == []
            assert resp["fingerprint"] == "fp-MECHTEXT"
            assert a.uploads == b.uploads == ["gri"]
        finally:
            a.close()
            b.close()

    def test_upload_partial_failure_is_loud(self, fleet_dir):
        a = FakeMember(fleet_dir, "a")
        b = FakeMember(fleet_dir, "b")
        try:
            router = _router(fleet_dir)
            b.kill_http()
            status, resp = router.upload(
                {"id": "gri", "mech": "M", "therm": "T"})
            assert status == 500
            assert resp["error"]["code"] == "internal"
            assert resp["replication"]["replicated"] == ["a"]
            assert resp["replication"]["failed"] == ["b"]
        finally:
            a.close()
            b.close()

    def test_late_joiner_absorbs_journal_before_routing(self, fleet_dir):
        a = FakeMember(fleet_dir, "a")
        try:
            router = _router(fleet_dir)
            router.upload({"id": "gri", "mech": "M", "therm": "T"})
            router.upload({"id": "gri", "mech": "M2", "therm": "T"})
            router.upload({"id": "ni", "mech": "N", "therm": "T"})
            assert a.uploads == ["gri", "gri", "ni"]
            b = FakeMember(fleet_dir, "b")
            try:
                # the next view must replay the CURRENT set (latest per
                # id) to b before it can own an arc
                assert "b" in router.healthz()["router"]["routable"]
                assert b.uploads == ["gri", "ni"]
                assert router.healthz()["router"]["uploads"] == [
                    "gri", "ni"]
            finally:
                b.close()
        finally:
            a.close()

    def test_invalid_upload_and_empty_fleet_upload(self, fleet_dir):
        router = _router(fleet_dir)
        status, resp = router.upload({"id": "x"})     # no mech/therm
        assert status == 400 and resp["error"]["code"] == "invalid"
        status, resp = router.upload(
            {"id": "x", "mech": "M", "therm": "T"})
        assert status == 503 and resp["error"]["code"] == "internal"

    def test_metrics_and_healthz_surfaces(self, fleet_dir):
        a = FakeMember(fleet_dir, "a")
        try:
            router = _router(fleet_dir)
            router.solve(_solve_req(0))
            text = router.metrics_text()
            # the obs/counters.py FAMILIES enrollment: router counters
            # and the route_seconds histogram are first-class families
            assert "route_requests" in text
            assert "route_seconds" in text
            h = router.healthz()
            assert h["ok"] is True
            assert h["router"]["routable"] == ["a"]
            assert abs(sum(h["router"]["arc_share"].values()) - 1.0) < 0.01
            # membership gauges published on the view refresh
            assert "fleet_members_routable" in text
        finally:
            a.close()

    def test_member_death_ages_out_of_ring(self, fleet_dir):
        a = FakeMember(fleet_dir, "a", heartbeat_s=0.02)
        b = FakeMember(fleet_dir, "b", heartbeat_s=0.02)
        try:
            router = _router(fleet_dir, dead_after_s=0.15)
            assert sorted(router.healthz()["router"]["routable"]) == [
                "a", "b"]
            a.membership._hb.stop()     # a stops beating (wedged/dead)
            time.sleep(0.4)
            h = router.healthz()
            assert h["router"]["routable"] == ["b"]
            # arcs reassigned: every key now routes to b, no failover
            for i in range(4):
                status, resp = router.solve(_solve_req(i, t1=1e-6 * (i + 1)))
                assert status == 200
                assert resp["router"]["host"] == "b"
                assert not resp["router"]["failover"]
            counters = router.recorder.snapshot()[2]
            assert counters["fleet_members_joined"] == 2
            assert counters["fleet_members_left"] == 1
        finally:
            a.close()
            b.close()


class TestRouterTracing:
    """Distributed tracing through the router (docs/observability.md
    "Fleet tracing"): context minting/forwarding, the hop ledger, the
    terminal events error-rate SLOs count, and the ctx-less
    byte-identity contract the acceptance pins."""

    def _trace_events(self, router):
        _s, events, _c = router.recorder.snapshot()
        return [e["attrs"] for e in events
                if e["name"] == "request_trace"]

    def test_ctxless_request_minted_and_response_byte_identical(
            self, fleet_dir):
        a = FakeMember(fleet_dir, "a")
        try:
            router = _router(fleet_dir)
            status, resp = router.solve(_solve_req(0))
            assert status == 200
            # byte-identity: the RESPONSE carries no trace ids and the
            # router section is EXACTLY the pre-tracing dict
            assert resp["router"] == {"host": "a", "attempts": 1,
                                      "failover": False, "tried": []}
            assert set(resp) == {"v", "id", "status", "served_by",
                                 "router"}
            # ...but the member received a minted context, hop 1
            fwd = a.requests[0]["trace_ctx"]
            assert fwd["trace"].startswith("r-")
            assert fwd["span"] == "route:1" and fwd["hop"] == 1
            (ev,) = self._trace_events(router)
            assert ev["minted"] is True
            assert ev["trace"] == fwd["trace"]
            assert ev["host"] == "a" and "code" not in ev
            assert [h["outcome"] for h in ev["hops"]] == ["ok"]
            hop = ev["hops"][0]
            assert hop["member"] == "a" and hop["hop"] == 1
            assert hop["send_wall"] <= hop["recv_wall"]
        finally:
            a.close()

    def test_inherited_ctx_forwarded_with_hop_advance(self, fleet_dir):
        a = FakeMember(fleet_dir, "a")
        try:
            router = _router(fleet_dir)
            obj = _solve_req(0)
            obj["trace_ctx"] = schema.trace_ctx_payload(
                "t-cli", span="client", hop=3)
            status, _resp = router.solve(obj)
            assert status == 200
            fwd = a.requests[0]["trace_ctx"]
            assert fwd == {"v": schema.TRACE_CTX_VERSION,
                           "trace": "t-cli", "span": "route:4",
                           "hop": 4}
            (ev,) = self._trace_events(router)
            assert ev["minted"] is False
            assert ev["trace"] == "t-cli"
            assert ev["parent_span"] == "client" and ev["hop"] == 3
        finally:
            a.close()

    def test_invalid_ctx_rejected_and_counted(self, fleet_dir):
        a = FakeMember(fleet_dir, "a")
        try:
            router = _router(fleet_dir)
            obj = _solve_req(0)
            obj["trace_ctx"] = {"trace": "t", "bogus": 1}
            status, resp = router.solve(obj)
            assert status == 400
            assert resp["error"]["code"] == "invalid"
            assert a.requests == []     # rejected before any forward
            (ev,) = self._trace_events(router)
            assert ev["failed"] is True and ev["code"] == "invalid"
            assert ev["hops"] == []
            # the rejection is an SLO sample: error-rate counts it
            res = router.slo.evaluate()
            assert res["error_rate"]["bad"] == 1
        finally:
            a.close()

    def test_error_responses_emit_terminal_trace_events(self,
                                                        fleet_dir):
        """Every router error path — upstream
        rejection, empty fleet — lands ONE terminal ``request_trace``
        with its rejection code, so error-rate SLOs see what the
        response alone would hide."""
        a = FakeMember(fleet_dir, "a", error=(503, "overloaded"))
        try:
            router = _router(fleet_dir)
            status, _resp = router.solve(_solve_req(0))
            assert status == 503
            (ev,) = self._trace_events(router)
            assert ev["failed"] is True and ev["code"] == "overloaded"
            assert ev["host"] == "a"
            assert [h["outcome"] for h in ev["hops"]] == ["overloaded"]
            a.close()
            router._view(force=True)
            status, _resp = router.solve(_solve_req(1))
            assert status == 503
            evs = self._trace_events(router)
            assert evs[-1]["code"] == "internal"
            assert evs[-1]["hops"] == []
            res = router.slo.evaluate()
            assert res["error_rate"]["bad"] == 2
        finally:
            a.close()

    def test_failover_hop_ledger_is_one_trace(self, fleet_dir):
        a = FakeMember(fleet_dir, "a")
        b = FakeMember(fleet_dir, "b")
        try:
            router = _router(fleet_dir)
            _s, first = router.solve(_solve_req(0))
            dead, survivor = ((a, b) if first["router"]["host"] == "a"
                              else (b, a))
            dead.kill_http()
            status, resp = router.solve(_solve_req(1))
            assert status == 200
            ev = self._trace_events(router)[-1]
            assert ev["failover"] is True
            assert ev["tried"] == resp["router"]["tried"] == [dead.name]
            assert [(h["member"], h["hop"], h["outcome"])
                    for h in ev["hops"]] == [
                (dead.name, 1, "transport"), (survivor.name, 2, "ok")]
            # both hops under ONE trace id, which the survivor received
            assert survivor.requests[-1]["trace_ctx"]["trace"] \
                == ev["trace"]
            assert survivor.requests[-1]["trace_ctx"]["span"] \
                == "route:2"
            res = router.slo.evaluate()
            assert res["failover_rate"]["bad"] == 1
        finally:
            a.close()
            b.close()

    def test_metrics_text_carries_slo_gauges(self, fleet_dir):
        a = FakeMember(fleet_dir, "a")
        try:
            router = _router(fleet_dir)
            router.solve(_solve_req(0))
            text = router.metrics_text()
            assert "# TYPE br_slo_burn_rate gauge" in text
            assert 'br_slo_requests{window="slow"} 1' in text
            assert 'br_slo_alert{objective="error_rate"} 0' in text
            # the base exposition is intact alongside
            assert "route_requests" in text
        finally:
            a.close()


class TestFleetSnapshotMergeLateJoiner:
    def test_member_snapshot_without_histograms_merges_as_empty(
            self, fleet_dir):
        """A member snapshot missing the
        ``histograms`` key entirely (a late joiner that has not
        observed yet, or a pre-histogram writer) merges as EMPTY
        through the router's /metrics fleet exposition — never a
        KeyError, never a fabricated series."""
        from batchreactor_tpu_torch.obs.live import (
            LiveRegistry, write_fleet_snapshot)
        from batchreactor_tpu_torch.obs.recorder import Recorder

        a = FakeMember(fleet_dir, "a")
        try:
            router = _router(fleet_dir)
            rec = Recorder()
            rec.counter("serve_answered", 2)
            for d in (0.01, 0.04):
                rec.observe("serve_stage_seconds", d, stage="total")
            write_fleet_snapshot(fleet_dir, 1,
                                 LiveRegistry(recorder=rec))
            # the late joiner: counters only, no "histograms" key
            hosts = os.path.join(fleet_dir, "hosts")
            os.makedirs(hosts, exist_ok=True)
            with open(os.path.join(hosts, "p2.metrics.json"),
                      "w") as f:
                json.dump({"pid": 2, "time": time.time(),
                           "counters": {"serve_answered": 1},
                           "gauges": {}}, f)
            text = router.metrics_text()
            # merged family = exactly the ONE host's observations
            assert ('br_fleet_serve_stage_seconds_count'
                    '{stage="total"} 2') in text
            # both hosts' counters still merged
            assert 'host="p1",name="serve_answered"' in text
            assert 'host="p2",name="serve_answered"' in text
        finally:
            a.close()


# --------------------------------------------------------------------------
# one live fleet: two CPU daemons of the port behind the port's router
# --------------------------------------------------------------------------
_COMP = {"H2": 0.3, "O2": 0.15, "N2": 0.55}


def test_live_fleet_fails_over_to_the_same_answer(lib_dir, tmp_path):
    """The same request through the router before and after its serving
    member dies abruptly (HTTP gone, heartbeat fresh): the survivor's
    answer equals the first bit for bit, carries the failover provenance,
    is served warm, and the failover stitches into one trace."""
    from batchreactor_tpu_torch.obs import build_report
    from batchreactor_tpu_torch.obs.stitch import stitch
    from batchreactor_tpu_torch.serving.client import (SolveClient,
                                                       with_trace_ctx)
    from batchreactor_tpu_torch.serving.scheduler import Scheduler
    from batchreactor_tpu_torch.serving.server import ServingServer
    from batchreactor_tpu_torch.serving.session import SolverSession

    spec = {"mechanism": {"mech": f"{lib_dir}/h2o2.dat",
                          "therm": f"{lib_dir}/therm.dat"},
            "solver": {"segment_steps": 8, "stats": True},
            "serve": {"resident": 4, "refill": 1, "buckets": [4],
                      "poll_every": 1, "idle_timeout_s": 0.2,
                      "coalesce_s": 0.0}}
    fdir = str(tmp_path / "fleet")
    hosts = {}
    router = None
    try:
        for name in ("m1", "m2"):
            s = SolverSession.from_spec(spec, device="cpu")
            s.warmup()
            s.__enter__()
            srv = ServingServer(s, Scheduler(s)).start()
            srv.membership = MemberRegistration(
                fdir, name, srv.url, pid=f"e2e-{name}",
                registry=s.registry, heartbeat_s=0.1).register()
            hosts[name] = (s, srv)
        router = FleetRouter(fdir, dead_after_s=60.0, refresh_s=0.0,
                             request_timeout=60.0).start()
        client = SolveClient(router.url, timeout=60.0)
        req = {"T": [1150.0, 1250.0, 1350.0, 1450.0], "X": _COMP,
               "t1": 3e-5}
        first = client.solve({"id": "w1", **req})
        assert first["provenance"] == ["success"] * 4
        assert first["router"]["failover"] is False
        dead = first["router"]["host"]
        (survivor,) = [n for n in hosts if n != dead]
        srv = hosts[dead][1]
        srv._server.shutdown()
        srv._server.server_close()
        srv._thread.join()
        srv._server = srv._thread = None
        second = client.solve(with_trace_ctx({"id": "w2", **req}))
        assert second["router"] == {"host": survivor, "attempts": 2,
                                    "failover": True, "tried": [dead]}
        assert second["t"] == first["t"]
        assert second["x"] == first["x"]
        assert second["n_accepted"] == first["n_accepted"]
        assert all(v == 0 for v in
                   hosts[survivor][0].program_compiles().values())
        reports = [(n, s.obs_report()) for n, (s, _srv) in hosts.items()]
        reports.append(("router", build_report(recorder=router.recorder)))
        (t,) = [t for t in stitch(reports) if t["request"] == "w2"]
        assert t["trace"] == "t-w2" and t["failover"] is True
        assert [(h["member"], h["outcome"]) for h in t["hops"]] == [
            (dead, "transport"), (survivor, "ok")]
        assert t["hops"][1]["member_trace"]["parent_span"] == "route:2"
        time.sleep(0.25)     # a heartbeat: both snapshots on disk
        text = router.metrics_text()
        assert "route_failovers" in text
        assert 'host="pe2e-m1"' in text and 'host="pe2e-m2"' in text
    finally:
        if router is not None:
            router.close()
        for s, srv in hosts.values():
            try:
                srv.close(drain_timeout=10.0)
            except Exception:  # noqa: BLE001 — the killed member's HTTP
                pass           # is already gone
            srv.membership.deregister()
            s.__exit__(None, None, None)
            s.release()
