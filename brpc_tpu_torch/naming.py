"""Service discovery for the Python tier over the native naming registry.

The registry itself is native (cpp/cluster/remote_naming.h — the consul
analog: versioned clusters, blocking Watch, TTL registrations); any brt
server hosts it via ``rpc.Server.add_naming_registry()``. This module is
the Python-side client, speaking the registry's JSON mapping over plain
HTTP (the restful bridge, cpp/rpc/json.h) so no binary codec is needed:

    reg = NamingClient("127.0.0.1:7000")
    reg.register("ps", "127.0.0.1:7100", ttl_ms=10_000)   # + heartbeats
    nodes, version = reg.list("ps")
    nodes, version = reg.watch("ps", known_version=version, wait_ms=30_000)

`RemoteEmbedding.from_registry` (ps_remote.py) builds the PS shard list
from a cluster, ordered by registration tag "<shard>/<num_shards>".

Two higher-level records also live in the same registry namespace:

- :class:`PartitionScheme` — a VERSIONED partitioning of the table
  (shard count + row-range map + replica sets + capacity weight +
  lifecycle state), published as one registry node per scheme
  (``addr="scheme#<version>"``, JSON tag).  Multiple schemes coexist
  during a live reshard (the DynamicPartitionChannel contract, SURVEY
  §2.7): clients weight read traffic across them and the migration
  driver walks a scheme through active → draining → retired.
- primary/epoch CLAIMS — shard tags may carry an ``@e<epoch>P|B``
  suffix (scheme-scoped form ``@v<scheme>e<epoch>P|B``) refreshed per
  heartbeat (``register(tag_fn=...)``), so failover state converges
  from one shared view instead of every client re-sweeping replicas
  (see ``parse_claim_tag``).
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import math
import threading
from typing import Dict, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ReplicaSet:
    """One shard range's replica group: every address serves the SAME
    row range; ``primary`` indexes the replica that owns writes at boot
    (runtime promotion is the client's/fabric's business — this is the
    declared topology, reference SelectiveChannel's "replica groups per
    partition" shape, SURVEY §2.6–2.7).

    Declared in the naming registry with tags ``"<shard>/<num>"``
    (replica 0 — the boot primary, also the legacy single-owner form)
    and ``"<shard>/<num>/<replica>"`` (backups); parsed back by
    :func:`parse_shard_tag` / consumed by
    ``RemoteEmbedding.from_registry``."""

    addresses: Tuple[str, ...]
    primary: int = 0

    def __post_init__(self):
        if not self.addresses:
            raise ValueError("ReplicaSet needs at least one address")
        if not 0 <= self.primary < len(self.addresses):
            raise ValueError(
                f"primary index {self.primary} outside "
                f"[0, {len(self.addresses)})")

    @classmethod
    def of(cls, addrs: "str | Sequence[str]") -> "ReplicaSet":
        """Normalize a bare address or an address sequence."""
        if isinstance(addrs, ReplicaSet):
            return addrs
        if isinstance(addrs, str):
            return cls((addrs,))
        return cls(tuple(str(a) for a in addrs))


def shard_tag(shard: int, num_shards: int, replica: int = 0, *,
              epoch: Optional[int] = None,
              primary: Optional[bool] = None,
              scheme: Optional[int] = None) -> str:
    """Registration tag for shard ``shard`` of ``num_shards``: replica 0
    keeps the legacy two-field form so pre-replication registrants and
    resolvers interoperate.  ``epoch``/``primary`` append a CLAIM suffix
    (``@e<epoch>P`` or ``@e<epoch>B``) — the server's current failover
    state, refreshed per heartbeat via ``register(tag_fn=...)`` so
    clients can adopt the claimed primary without sweeping replicas.
    ``scheme`` scopes the claim to one partition scheme VERSION
    (``@v<scheme>e<epoch>P``): two coexisting schemes with the same
    shard count (a bounds-only reshard, a merge back) must not mask
    each other's claims, mirroring the per-scheme writer keys."""
    base = f"{shard}/{num_shards}" if replica == 0 \
        else f"{shard}/{num_shards}/{replica}"
    if epoch is None:
        return base
    ver = "" if scheme is None else f"v{scheme}"
    return f"{base}@{ver}e{epoch}{'P' if primary else 'B'}"


def parse_shard_tag(tag: str) -> Optional[Tuple[int, int, int]]:
    """``(shard, num_shards, replica)`` from a registration tag, or
    ``None`` for tags that are not shard tags.  A claim suffix
    (``@e<epoch>P|B``) is tolerated and stripped — claim-carrying
    heartbeats stay visible to claim-unaware resolvers."""
    parts = tag.split("@", 1)[0].split("/")
    if len(parts) not in (2, 3):
        return None
    try:
        shard, num = int(parts[0]), int(parts[1])
        replica = int(parts[2]) if len(parts) == 3 else 0
    except ValueError:
        return None
    # Fuzz-hardened: int() happily parses "-1" and "+0007", but a shard
    # outside [0, num) or a non-positive shard count can only poison the
    # resolver's grouping arithmetic downstream — not a shard tag.
    if replica < 0 or shard < 0 or num <= 0 or shard >= num:
        return None
    return shard, num, replica


def parse_claim_tag(
        tag: str
) -> Optional[Tuple[int, int, int, int, bool, Optional[int]]]:
    """``(shard, num_shards, replica, epoch, is_primary, scheme)`` from
    a claim-suffixed shard tag, or ``None`` when the tag carries no
    claim (plain shard tags parse with :func:`parse_shard_tag`).
    ``scheme`` is ``None`` for legacy unscoped claims (``@e<epoch>P``);
    scheme-scoped claims carry ``@v<scheme>e<epoch>P``."""
    base = parse_shard_tag(tag)
    if base is None or "@" not in tag:
        return None
    suffix = tag.split("@", 1)[1]
    scheme: Optional[int] = None
    if suffix.startswith("v"):
        head, sep, rest = suffix[1:].partition("e")
        if not sep:
            return None
        try:
            scheme = int(head)
        except ValueError:
            return None
        suffix = "e" + rest
    if not suffix.startswith("e") or suffix[-1] not in ("P", "B"):
        return None
    try:
        epoch = int(suffix[1:-1])
    except ValueError:
        return None
    # Negative epochs/scheme versions never exist (fencing epochs only
    # grow from 0; scheme versions are registry-encodable naturals) — a
    # tag carrying one is hostile or corrupt, not a claim.
    if epoch < 0 or (scheme is not None and scheme < 0):
        return None
    return base[0], base[1], base[2], epoch, suffix[-1] == "P", scheme


#: lifecycle states a published scheme moves through: ``preparing``
#: (published at copy start — its shards still import; a fallback
#: route, never the weighted pick or the write owner), ``active``
#: (serves reads and — the newest active — owns writes), ``draining``
#: (reads only while its traffic weight decays), ``retired`` (must not
#: be routed to at all; its servers may already be gone).
SCHEME_STATES = ("preparing", "active", "draining", "retired")

#: scheme records are registry nodes too, but the native registry
#: validates ``addr`` as a real endpoint — so a scheme registers under
#: the reserved address ``0.0.0.0:<version>`` (never a routable server)
#: and is recognized by its TAG prefix; the JSON payload rides the tag.
SCHEME_TAG_PREFIX = "scheme!"


def scheme_record_addr(version: int) -> str:
    if not 0 <= version < 65536:
        raise ValueError(
            f"scheme version {version} outside the registry-encodable "
            f"range [0, 65536)")
    return f"0.0.0.0:{version}"


@dataclasses.dataclass(frozen=True)
class PartitionScheme:
    """One VERSIONED partitioning of a table: the row-range map, the
    replica group serving each range, and how much read traffic the
    scheme should carry (the reference DynamicPartitionChannel keeps
    multiple partitioning schemes alive simultaneously and weights
    traffic by capacity, partition_channel.h:136 /
    dynpart_load_balancer.cpp — this is that object made first-class
    and published through the naming registry).

    ``bounds`` is the explicit row-range map (``bounds[s] <= id <
    bounds[s+1]`` owns shard ``s``); ``None`` means uniform ranges over
    the consumer's vocab.  ``weight`` is the scheme's capacity share of
    READ traffic (writes always go to the newest active scheme).
    """

    version: int
    replica_sets: Tuple[ReplicaSet, ...]
    weight: float = 1.0
    state: str = "active"
    bounds: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.version < 0:
            raise ValueError(f"scheme version {self.version} < 0")
        if not self.replica_sets:
            raise ValueError("a scheme needs at least one shard")
        object.__setattr__(self, "replica_sets", tuple(
            ReplicaSet.of(rs) for rs in self.replica_sets))
        if self.weight < 0:
            raise ValueError(f"scheme weight {self.weight} < 0")
        if self.state not in SCHEME_STATES:
            raise ValueError(f"unknown scheme state {self.state!r}; "
                             f"valid: {', '.join(SCHEME_STATES)}")
        if self.bounds is not None:
            b = tuple(int(x) for x in self.bounds)
            if len(b) != len(self.replica_sets) + 1 or b[0] != 0 or \
                    any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
                raise ValueError(
                    f"bounds {b} must be strictly increasing, start at "
                    f"0, and have num_shards+1 entries")
            object.__setattr__(self, "bounds", b)

    @property
    def num_shards(self) -> int:
        return len(self.replica_sets)

    def shard_bounds(self, s: int, vocab: int) -> Tuple[int, int]:
        """``[lo, hi)`` row range of shard ``s`` under this scheme."""
        if self.bounds is not None:
            return self.bounds[s], self.bounds[s + 1]
        rows_per = vocab // self.num_shards
        return s * rows_per, (s + 1) * rows_per

    def with_(self, **changes) -> "PartitionScheme":
        """A copy with ``changes`` applied (weight/state transitions)."""
        return dataclasses.replace(self, **changes)

    def to_json(self) -> str:
        return json.dumps({
            "version": self.version,
            "replica_sets": [
                {"addresses": list(rs.addresses), "primary": rs.primary}
                for rs in self.replica_sets],
            "weight": self.weight,
            "state": self.state,
            "bounds": list(self.bounds) if self.bounds else None,
        })

    @classmethod
    def from_json(cls, text: str) -> "PartitionScheme":
        """Strict record parse — registry records are hostile input
        (anything can publish a ``scheme!`` tag).  Shape violations the
        dataclass validation cannot see raise ``ValueError`` here: a
        string where an address LIST belongs (``tuple("abc")`` silently
        becomes three one-char addresses), a non-finite weight (inf/nan
        poisons every capacity-weighting comparison downstream), or a
        non-list bounds."""
        d = json.loads(text)
        if not isinstance(d, dict):
            raise ValueError("scheme record must be a JSON object")
        rs_in = d["replica_sets"]
        if not isinstance(rs_in, (list, tuple)):
            raise ValueError("replica_sets must be a list")
        sets = []
        for rs in rs_in:
            if not isinstance(rs, dict):
                raise ValueError("replica set must be an object")
            addrs = rs["addresses"]
            if not isinstance(addrs, (list, tuple)) or not all(
                    isinstance(a, str) for a in addrs):
                raise ValueError("addresses must be a list of strings")
            sets.append(ReplicaSet(tuple(addrs),
                                   primary=int(rs.get("primary", 0))))
        weight = float(d.get("weight", 1.0))
        if not math.isfinite(weight):
            raise ValueError(f"scheme weight {weight} is not finite")
        bounds = d.get("bounds")
        if bounds is not None and not isinstance(bounds, (list, tuple)):
            raise ValueError("bounds must be a list")
        return cls(
            version=int(d["version"]),
            replica_sets=tuple(sets),
            weight=weight,
            state=d.get("state", "active"),
            bounds=tuple(bounds) if bounds else None)


def publish_scheme(client: "NamingClient", cluster: str,
                   scheme: PartitionScheme) -> int:
    """Publishes (or re-publishes — weight/state updates re-register the
    same node) ``scheme`` into ``cluster``.  Returns the new registry
    version; watchers holding the old version wake immediately."""
    return client.register(
        cluster, scheme_record_addr(scheme.version),
        tag=SCHEME_TAG_PREFIX + scheme.to_json(), heartbeat=False)


def parse_schemes(nodes: Sequence[dict]) -> Dict[int, PartitionScheme]:
    """Every scheme record in a cluster listing, by version (the LAST
    occurrence of a version wins — registration order is publication
    order, so re-published weight/state transitions supersede)."""
    out: Dict[int, PartitionScheme] = {}
    for n in nodes:
        tag = n.get("tag", "")
        if not isinstance(tag, str) or \
                not tag.startswith(SCHEME_TAG_PREFIX):
            continue
        try:
            scheme = PartitionScheme.from_json(
                tag[len(SCHEME_TAG_PREFIX):])
        except (ValueError, KeyError, TypeError, RecursionError):
            # RecursionError: json.loads on a deeply-nested hostile
            # payload ("[[[[…") overflows the decoder's stack — a
            # malformed record, not a parser crash.
            continue
        out[scheme.version] = scheme
    return out


def parse_claims(
        nodes: Sequence[dict]
) -> Dict[Tuple[Optional[int], int, int], Tuple[int, str]]:
    """Primary claims from claim-suffixed shard tags:
    ``{(scheme, num_shards, shard): (epoch, addr)}`` keeping the
    highest epoch per key.  Claims are SCOPED per scheme version so two
    coexisting schemes with the same shard count never mask each other
    (``scheme`` is ``None`` for legacy unscoped claims).  Only PRIMARY
    claims are returned — a backup's claim says who it is, not who owns
    the range."""
    out: Dict[Tuple[Optional[int], int, int], Tuple[int, str]] = {}
    for n in nodes:
        tag = n.get("tag", "")
        parsed = parse_claim_tag(tag) if isinstance(tag, str) else None
        if parsed is None:
            continue
        shard, num, _replica, epoch, is_primary, scheme = parsed
        if not is_primary:
            continue
        # a claim-tagged node without a routable addr is corrupt — a
        # KeyError here used to kill the whole listing's ingest
        addr = n.get("addr")
        if not isinstance(addr, str) or not addr:
            continue
        key = (scheme, num, shard)
        if key not in out or epoch >= out[key][0]:
            out[key] = (epoch, addr)
    return out


class NamingClient:
    def __init__(self, registry_addr: str, timeout_s: float = 35.0):
        self.addr = registry_addr
        self.timeout_s = timeout_s
        self._heartbeats: list[threading.Thread] = []
        self._stop = threading.Event()
        # One persistent keep-alive connection PER THREAD (watch blocks
        # for seconds while heartbeat threads keep renewing — they must
        # not share a socket), reused across polls instead of paying a
        # TCP handshake per probe.  All live connections are tracked for
        # close(); a broken one is dropped and recreated once.
        self._tls = threading.local()
        self._conns_mu = threading.Lock()
        self._conns: list[http.client.HTTPConnection] = []

    def _thread_conn(self) -> http.client.HTTPConnection:
        conn = getattr(self._tls, "conn", None)
        if conn is None:
            host, port = self.addr.rsplit(":", 1)
            conn = http.client.HTTPConnection(host, int(port),
                                              timeout=self.timeout_s)
            self._tls.conn = conn
            with self._conns_mu:
                self._conns.append(conn)
        return conn

    def _drop_thread_conn(self) -> None:
        conn = getattr(self._tls, "conn", None)
        if conn is None:
            return
        self._tls.conn = None
        with self._conns_mu:
            if conn in self._conns:
                self._conns.remove(conn)
        conn.close()

    def _call(self, method: str, payload: dict,
              timeout_s: Optional[float] = None) -> dict:
        body = json.dumps(payload)
        t = timeout_s or self.timeout_s
        for attempt in (0, 1):
            conn = self._thread_conn()
            conn.timeout = t
            if conn.sock is not None:
                conn.sock.settimeout(t)
            try:
                conn.request("POST", f"/Naming/{method}", body,
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = resp.read()
            except Exception:  # noqa: BLE001 — stale keep-alive socket:
                self._drop_thread_conn()   # reconnect once, then raise
                if attempt:
                    raise
                continue
            if resp.status != 200:
                raise RuntimeError(
                    f"Naming/{method} -> {resp.status}: {data!r}")
            return json.loads(data)
        raise AssertionError("unreachable")  # pragma: no cover

    def register(self, cluster: str, addr: str, weight: int = 1,
                 tag: str = "", ttl_ms: int = 0,
                 heartbeat: bool = True, tag_fn=None) -> int:
        """Registers addr in cluster; with a TTL and heartbeat=True a
        daemon thread renews at ttl/3 until close().  ``tag_fn`` (a
        callable returning the CURRENT tag) is re-evaluated on every
        heartbeat, so registrants can publish live state — a PS
        replica's primary/epoch claim rides its shard tag this way
        (see :func:`parse_claim_tag`)."""
        if self._stop.is_set():
            raise RuntimeError("NamingClient is closed")
        req = {"cluster": cluster, "addr": addr, "weight": weight}
        if tag_fn is not None:
            req["tag"] = str(tag_fn())
        elif tag:
            req["tag"] = tag
        if ttl_ms > 0:
            req["ttl_ms"] = ttl_ms
        version = int(self._call("Register", req).get("version", 0))
        if ttl_ms > 0 and heartbeat:
            t = threading.Thread(
                target=self._heartbeat_loop,
                args=(dict(req), ttl_ms / 3000.0, tag_fn),
                daemon=True)
            t.start()
            self._heartbeats.append(t)
        return version

    def _heartbeat_loop(self, req: dict, period_s: float,
                        tag_fn=None) -> None:
        while not self._stop.wait(period_s):
            try:
                if tag_fn is not None:
                    req["tag"] = str(tag_fn())
                self._call("Register", req)
            except Exception:  # noqa: BLE001 — registry outage: keep trying
                pass

    def deregister(self, cluster: str, addr: str) -> None:
        self._call("Deregister", {"cluster": cluster, "addr": addr})

    @staticmethod
    def _nodes(resp: dict) -> list[dict]:
        return resp.get("nodes", [])

    def list(self, cluster: str) -> tuple[list[dict], int]:
        resp = self._call("List", {"cluster": cluster})
        return self._nodes(resp), int(resp.get("version", 0))

    def watch(self, cluster: str, known_version: int = 0,
              wait_ms: int = 30_000) -> tuple[list[dict], int]:
        """Blocking query: returns when the cluster version passes
        known_version (or wait_ms elapses)."""
        resp = self._call(
            "Watch",
            {"cluster": cluster, "known_version": known_version,
             "wait_ms": wait_ms},
            timeout_s=wait_ms / 1000.0 + 5.0)
        return self._nodes(resp), int(resp.get("version", 0))

    def close(self) -> None:
        self._stop.set()
        with self._conns_mu:
            conns, self._conns = list(self._conns), []
        for conn in conns:
            conn.close()
