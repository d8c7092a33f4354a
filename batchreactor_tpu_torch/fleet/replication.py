"""Mechanism-upload replication: every member serves every mechanism.

``POST /mechanism`` against the router must leave the fleet uniform —
a request routed by mechanism id has to find that mechanism resident on
whichever member its hash arc names.  The protocol leans on properties
the serving store already has, so replication is a fan-out, not a
consensus round:

* **idempotent by fingerprint** — ``SessionStore._admit`` dedupes on
  the mechanism's content fingerprint, so delivering one upload to a
  member twice (a retry racing a slow first delivery, a journal replay
  to a member that already has it) admits once and re-aliases the id;
* **versioned by id** — re-uploading an id with new content builds a
  new session under that alias (latest wins), and the journal keeps
  only the latest per id, so a late joiner replays the current set,
  not the history;
* **answered honestly** — the router reports per-member results; a
  partial failure is a loud ``internal`` response naming the members
  that missed (the client retries; idempotency makes the retry safe),
  never a silently divergent fleet.

The :class:`UploadJournal` is router-local state: a member that joins
AFTER an upload gets the journal replayed to it before the ring routes
to it (``fleet/router.py``).  A *router* restart loses the journal but
not the fleet — members keep their resident mechanisms, and the next
upload repopulates it.

stdlib-only (urllib + threading): replication runs on router handler
threads.
"""

import json
import threading
import urllib.error
import urllib.request



class UploadJournal:
    """Module doc: the latest accepted upload object per id, in
    first-accepted order (replay order is deterministic)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_id = {}     # id -> upload object
        self._order = []     # ids, first-accepted order

    def record(self, upload):
        """Remember ``upload`` (a validated ``POST /mechanism`` body)
        under its id; re-recording an id replaces the payload (latest
        wins — the version semantics)."""
        uid = str(upload["id"])
        with self._lock:
            if uid not in self._by_id:
                self._order.append(uid)
            self._by_id[uid] = dict(upload)

    def replay(self):
        """The uploads a joining member must absorb, in order."""
        with self._lock:
            return [dict(self._by_id[uid]) for uid in self._order]

    def ids(self):
        with self._lock:
            return list(self._order)


def post_json(url, path, obj, timeout):
    """POST ``obj`` as JSON to ``url + path``; returns ``(status,
    parsed_body)``.  HTTP error statuses return their parsed body (the
    serving error-response grammar) rather than raising; only
    transport-level failures (``OSError`` — connection refused/reset,
    timeout) propagate, because only those mean "the member may not
    have seen this" and justify failover/retry."""
    body = json.dumps(obj).encode()
    req = urllib.request.Request(
        url.rstrip("/") + path, data=body,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.getcode(), json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read().decode())
        except (ValueError, OSError):
            return e.code, {"status": "error",
                            "error": {"code": "internal",
                                      "message": f"HTTP {e.code}: "
                                                 f"{e.reason}"}}


def replicate_upload(member, upload, timeout):
    """Deliver one upload to one member: ``{"member", "ok", "status",
    "response"}`` — transport failures fold into ``ok=False`` with a
    synthesized response (the caller aggregates; a replication sweep
    must report every member, not die at the first dead one)."""
    try:
        status, resp = post_json(member["url"], "/mechanism", upload,
                                 timeout)
    except OSError as e:
        return {"member": member["name"], "ok": False, "status": None,
                "response": {"status": "error",
                             "error": {"code": "internal",
                                       "message": f"transport: {e}"}}}
    return {"member": member["name"],
            "ok": bool(resp.get("status") == "ok"),
            "status": status, "response": resp}
