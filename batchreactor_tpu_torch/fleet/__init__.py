"""The replicated serving tier (docs/serving.md "Fleet").

The stage decomposition showed the saturated single daemon is
~92% queue-wait — admission-bound, not solve-bound — so the capacity
lever past one host is N daemons, not a bigger one.  This package
composes planes that already exist into that tier:

* :mod:`.ring` — the consistent-hash ring: requests route by
  (mechanism, pack key) so each member's warmed programs and
  resident streaming epochs stay hot, and membership churn moves only
  the departed arcs;
* :mod:`.membership` — elastic membership over a shared fleet dir via
  the ``resilience.heartbeat`` mtime convention (register / beat /
  drain-handshake / age-out), with each member dropping its
  ``obs.live`` metrics snapshot beside its beat;
* :mod:`.router` — the thin, device-free HTTP router: forward with
  failover (transport failure or ``draining`` -> next member
  clockwise; deterministic solves make the survivor's answer
  bit-exact, answered exactly once), replicate ``POST /mechanism``
  fleet-wide, and serve the merged fleet ``/metrics``;
* :mod:`.replication` — the upload journal + fan-out (idempotent by
  fingerprint, versioned by id, replayed to late joiners).

Nothing here touches a device (the modules import neither torch nor
jax): a wedged device must never take the routing/telemetry plane down
with it.  Port of ``batchreactor_tpu/fleet``: the ring, the member files
and the upload journal are the reference's, so a fleet may mix members
of both packages.  Entry points:
``tools/serve_fleet.py`` (N daemons + router under one supervisor),
``tools/serve.py --fleet-dir`` (one member), ``tools/serve_bench.py
--router N`` (the fleet bench protocol).
"""

from .membership import (DEFAULT_DEAD_AFTER_S, DEFAULT_HEARTBEAT_S,
                         MemberInfo, MemberRegistration,
                         member_obs_path, member_paths, obs_dir,
                         read_members)
from .replication import UploadJournal, replicate_upload
from .ring import DEFAULT_VNODES, HashRing, canonical_key, request_key
from .router import FleetRouter

__all__ = [
    "HashRing",
    "canonical_key",
    "request_key",
    "DEFAULT_VNODES",
    "MemberRegistration",
    "MemberInfo",
    "member_paths",
    "member_obs_path",
    "obs_dir",
    "read_members",
    "DEFAULT_HEARTBEAT_S",
    "DEFAULT_DEAD_AFTER_S",
    "UploadJournal",
    "replicate_upload",
    "FleetRouter",
]
