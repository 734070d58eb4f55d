"""Federated serving fleet — counterpart of ``gofr_tpu/ml/federation.py``,
on the same wire: one logical front over many hosts.

Every fleet mechanism below this layer — cache-aware routing, elastic
scaling, disagg roles, canary promotion — stops at one process. This
module is the control plane that doesn't: a ``FederatedPool`` fronts the
host-local server (``LLMServer`` or ``ReplicaPool``) and peers with the
same construct on other hosts over the ``multihost.py`` wire (length-
prefixed JSON frames + binary KV frames), growing the fleet past one
host's devices. Three legs:

- **Membership + health.** Every host gossips a beat every
  ``gossip_s`` seconds: host id, serving health, queue depth, warm flag,
  and a radix-trie **digest summary** (``[prefix_len, token_digest]``
  rows of its hottest cached prefixes). A peer that misses
  ``suspect_beats`` beats is *suspect*, after ``dead_beats`` it is
  *dead*: its in-flight remote work re-admits on the local survivor
  **front-of-class** (``ReplicaPool.stream_chunks(front=True)``) and
  prompts that would have ridden its pinned prefixes fall back to full
  prefill — the replica pool's drain-and-reroute lifted one level up.
- **Remote routing.** The routing table grows remote-host rows: a
  request whose prompt matches a peer's gossiped digest deeper than any
  local radix hit routes to that peer as a ``gen`` frame, and the
  journey keeps ONE trace id across the socket (the frame carries the
  W3C ``traceparent``; the serving side parents its span there).
- **Host join/leave.** A joining host is routable only after a warm
  beat: members that see it join push their pinned prefixes
  (``pin`` frames) so it backfills before taking traffic. A leaving
  host live-migrates its hot subtrees to a survivor over the existing
  cross-host ``migrate_bytes`` leg — the ships == adoptions + failures
  ledger closes fleet-wide (a frame lost on the wire is accounted by
  the sender via ``account_lost_migration``).

**Failure semantics are the headline.** Every remote leg degrades to
the single-host path *bit-identically*: a peer that is dead,
partitioned, or silent past the liveness deadline fails the remote
attempt with a typed error, and — if no token was yielded yet — the
request re-admits locally (the recompute is charged to the goodput
ledger as ``federation_recompute``). A remote stream that already
yielded surfaces ``GeneratorCrashed``, exactly like a replica loss
mid-stream. No call ever hangs: every wire wait is bounded by the
liveness deadline.

Configuration rides ``GOFR_ML_FEDERATION`` (unset ⇒ ``federation_from_env``
answers ``None`` and ``register_llm`` constructs NO federation machinery
— the same is-not-None zero-overhead contract as every other serving
knob)::

    GOFR_ML_FEDERATION=a=10.0.0.1:9101,b=10.0.0.2:9101   # all members
    GOFR_ML_FEDERATION_SELF=a                            # which one is me
    GOFR_ML_FED_GOSSIP_S=1.0          # beat period (seconds)
    GOFR_ML_FED_SUSPECT_BEATS=3       # missed beats -> suspect
    GOFR_ML_FED_DEAD_BEATS=6          # missed beats -> dead

Chaos: the ``peer_send`` / ``peer_recv`` points fire inside the shared
framing helpers, and ``peer_partition`` at this link layer — outbound
sends fail and inbound frames silently drop, so a partitioned peer
looks alive-but-unreachable (gossip silence → suspect → dead) instead
of cleanly disconnected.

Observability: ``health()`` answers ``degraded`` while any member is
down and ``dead`` only when every host (local included) is; ``/debug/
serving`` federates with per-host rows (``federation_snapshot``); the
``peer_up`` / ``peer_suspect`` / ``peer_dead`` / ``host_join`` /
``host_leave`` fleet events narrate membership; and the
``app_llm_fed_peer_state`` / ``app_llm_fed_remote_routed_total`` /
``app_llm_fed_remote_failovers_total`` metrics cover the remote plane.
"""

from __future__ import annotations

import asyncio
import os
import socket
import struct
import threading
import time
from typing import Any, AsyncIterator

from ..flight_recorder import event_log
from ..testutil.faults import FaultInjector, fault_snapshot
from ..tracing import current_context, current_traceparent, parse_traceparent
from .capture import token_digest
from .errors import DeadlineExceeded, GeneratorCrashed, ServerClosed
from .goodput import goodput_ledger
from .journey import Journey, journey_log, next_rid, seal
from .kv_transport import KVTransport
from .multihost import _Conn, recv_frame, send_bytes, send_frame

__all__ = ["FederationConfig", "FederatedPool", "federation_from_env"]

# wire ops (JSON frames; binary frames are always migration payloads)
_OP_GOSSIP = "gossip"
_OP_GEN = "gen"
_OP_CANCEL = "cancel"
_OP_PIN = "pin"
_OP_LEAVE = "leave"

# error-frame etype marking a transport-level loss (vs a typed serving
# error relayed from the remote host)
_ETYPE_CONN = "_conn"

# remote etypes that surface typed to the caller instead of falling back
# to the local path: the failure is about the REQUEST, not the peer
_TYPED_REMOTE = {"DeadlineExceeded": DeadlineExceeded,
                 "ValueError": ValueError}


class _RemoteFailed(Exception):
    """Internal: the remote attempt died for peer reasons (dead link,
    partition, liveness deadline, remote crash/close) — the caller falls
    back to the local path when nothing was yielded yet."""


class FederationConfig:
    """Static membership + liveness thresholds for one federated host."""

    def __init__(self, host_id: str, listen: tuple[str, int],
                 peers: dict[str, tuple[str, int]], *,
                 gossip_s: float = 1.0, suspect_beats: int = 3,
                 dead_beats: int = 6, affinity_min_tokens: int = 8,
                 pin_limit: int = 32, digest_limit: int = 16,
                 frame_gap_s: float | None = None) -> None:
        if not host_id:
            raise ValueError("federation host_id must be non-empty")
        if host_id in peers:
            raise ValueError(
                f"federation host {host_id!r} cannot peer with itself")
        if not gossip_s > 0:
            raise ValueError(f"gossip_s must be > 0, got {gossip_s}")
        if not 0 < suspect_beats < dead_beats:
            raise ValueError(
                f"need 0 < suspect_beats < dead_beats, got "
                f"{suspect_beats}/{dead_beats}")
        self.host_id = str(host_id)
        self.listen = (str(listen[0]), int(listen[1]))
        self.peers = {str(k): (str(h), int(p))
                      for k, (h, p) in peers.items()}
        self.gossip_s = float(gossip_s)
        self.suspect_beats = int(suspect_beats)
        self.dead_beats = int(dead_beats)
        self.affinity_min_tokens = int(affinity_min_tokens)
        self.pin_limit = int(pin_limit)
        self.digest_limit = int(digest_limit)
        # liveness deadline for any single wire wait: a healthy peer is
        # never silent between stream frames longer than it takes the
        # membership layer to declare it dead, so this is the ONE bound
        # that makes "no hangs" true by construction
        self.frame_gap_s = (max(2.0, dead_beats * gossip_s)
                            if frame_gap_s is None else float(frame_gap_s))

    def suspect_after_s(self) -> float:
        return self.suspect_beats * self.gossip_s

    def dead_after_s(self) -> float:
        return self.dead_beats * self.gossip_s


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"{name} must be a number, got {raw!r}") from None


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {raw!r}") from None


def federation_from_env() -> FederationConfig | None:
    """Parse ``GOFR_ML_FEDERATION`` (+ ``GOFR_ML_FEDERATION_SELF`` and the
    ``GOFR_ML_FED_*`` knobs) into a config; ``None`` (federation off,
    zero overhead) when unset. Malformed specs fail loudly at startup —
    a typo'd fleet map must not boot a silently solo host."""
    spec = os.environ.get("GOFR_ML_FEDERATION", "").strip()
    if not spec:
        return None
    members: dict[str, tuple[str, int]] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        hid, sep, addr = part.partition("=")
        host, psep, port = addr.rpartition(":")
        if not sep or not psep or not hid.strip():
            raise ValueError(
                f"bad GOFR_ML_FEDERATION entry {part!r} "
                f"(want id=host:port)")
        try:
            members[hid.strip()] = (host.strip() or "127.0.0.1", int(port))
        except ValueError:
            raise ValueError(
                f"bad port in GOFR_ML_FEDERATION entry {part!r}") from None
    if not members:
        raise ValueError(f"empty GOFR_ML_FEDERATION spec {spec!r}")
    self_id = os.environ.get("GOFR_ML_FEDERATION_SELF", "").strip()
    if not self_id:
        raise ValueError(
            "GOFR_ML_FEDERATION is set but GOFR_ML_FEDERATION_SELF is "
            "not — name which member this host is")
    if self_id not in members:
        raise ValueError(
            f"GOFR_ML_FEDERATION_SELF={self_id!r} is not a member of "
            f"GOFR_ML_FEDERATION ({sorted(members)})")
    listen = members[self_id]
    peers = {k: v for k, v in members.items() if k != self_id}
    return FederationConfig(
        self_id, listen, peers,
        gossip_s=_env_float("GOFR_ML_FED_GOSSIP_S", 1.0),
        suspect_beats=_env_int("GOFR_ML_FED_SUSPECT_BEATS", 3),
        dead_beats=_env_int("GOFR_ML_FED_DEAD_BEATS", 6))


class _FedConn(_Conn):
    """An inbound federation connection: the shared ``_Conn`` writer
    (bounded queue + writer thread, so a slow peer never blocks the
    serve loop) with the chaos hook threaded into the frame write."""

    __slots__ = ("fault",)

    def __init__(self, sock: socket.socket, fault=None) -> None:
        self.fault = fault
        super().__init__(sock)

    def _drain(self) -> None:
        while True:
            obj = self._q.get()
            try:
                if obj is None or not self.alive:
                    return
                try:
                    send_frame(self.sock, obj, fault=self.fault)
                except Exception:
                    self.alive = False
                    return
            finally:
                self._q.task_done()


class _Peer:
    """One remote member, as seen from this host: gossiped state + the
    outbound link (lazily dialed socket + response-reader thread) + the
    in-flight remote streams keyed by rid."""

    def __init__(self, host_id: str, addr: tuple[str, int]) -> None:
        self.host_id = host_id
        self.addr = addr
        self.state = "unknown"   # unknown | up | suspect | dead | left
        self.health: str | None = None
        self.queued = 0
        self.warm = False
        self.digests: list[tuple[int, str]] = []
        self.beats = 0
        self.last_beat: float | None = None
        self.lock = threading.Lock()   # guards sock lifecycle + sends
        self.sock: socket.socket | None = None
        # rid -> (caller loop, frame queue); failed wholesale on any
        # link/liveness event so no consumer can park forever
        self.streams: dict[str, tuple] = {}
        self.send_errors = 0
        self.remote_routed = 0

    def row(self) -> dict:
        """One per-host row of the federated ``/debug/serving`` view."""
        return {
            "addr": f"{self.addr[0]}:{self.addr[1]}",
            "state": self.state,
            "health": self.health,
            "queued": self.queued,
            "warm": self.warm,
            "beats": self.beats,
            "last_beat_s": (round(time.monotonic() - self.last_beat, 3)
                            if self.last_beat is not None else None),
            "digests": len(self.digests),
            "in_flight": len(self.streams),
            "routed": self.remote_routed,
            "send_errors": self.send_errors,
        }


class FederatedPool:
    """The cross-host serving front: wraps the host-local server and
    adds remote routing, membership, and host-level failover. Unknown
    attributes delegate to the local server, so the datasource's
    introspection (``gen``, ``replicas``, ``recorder``, …) keeps
    working unchanged."""

    def __init__(self, local: Any, config: FederationConfig, *,
                 name: str = "llm", metrics=None, tracer=None,
                 logger=None, fault: FaultInjector | None = None,
                 transport: KVTransport | None = None) -> None:
        self.local = local
        self.cfg = config
        self.name = name
        self._metrics = metrics
        self._tracer = tracer
        self._logger = logger
        self._events = event_log()
        self._goodput = goodput_ledger()
        self._journeys = journey_log()
        self._fault = FaultInjector.from_env() if fault is None else fault
        self._transport = transport if transport is not None else \
            KVTransport(name=name, metrics=metrics, tracer=tracer)
        self._lock = threading.Lock()
        self._closed = False
        self._leaving = False
        self._pins_synced = False
        self._boot = time.monotonic()
        self._wake = threading.Event()
        self.remote_routed = 0      # requests this host sent to peers
        self.remote_served = 0      # peer requests this host served
        self.remote_failovers = 0   # remote attempts recomputed locally
        self._local_is_pool = hasattr(local, "replicas")
        self._peers = {hid: _Peer(hid, addr)
                       for hid, addr in config.peers.items()}
        self._inbound: set[_FedConn] = set()
        # the serve loop drives inbound remote requests through the
        # local server's async API from a dedicated thread
        self._serve_loop = asyncio.new_event_loop()
        threading.Thread(target=self._serve_loop.run_forever,
                         daemon=True, name="gofr-fed-serve").start()
        # listener: peers dial us here; responses return on their socket
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind(config.listen)
        self._server.listen(16)
        self.listen_addr = self._server.getsockname()[:2]
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="gofr-fed-accept").start()
        self._gossip_thread = threading.Thread(
            target=self._gossip_loop, daemon=True, name="gofr-fed-gossip")
        self._gossip_thread.start()

    # delegation AFTER explicit methods: anything not defined here —
    # register_prefix, gen, replicas, recorder, resilience_snapshot —
    # answers from the local server
    def __getattr__(self, item):
        local = self.__dict__.get("local")
        if local is None:
            raise AttributeError(item)
        return getattr(local, item)

    def _log(self, msg: str) -> None:
        if self._logger is not None:
            try:
                self._logger.info(msg)
            except Exception:
                pass

    def _count(self, metric: str, n: int = 1, **labels) -> None:
        if self._metrics is None:
            return
        try:
            self._metrics.add_counter(metric, n, model=self.name, **labels)
        except Exception:
            pass

    # -- outbound link -------------------------------------------------------
    def _link_send(self, peer: _Peer, obj=None, payload: bytes | None = None,
                   connect_timeout: float | None = None) -> None:
        """Send one frame on the outbound link (dialing it first if
        needed). Raises on ANY failure — the callers' fallback paths are
        the error handling. ``peer_partition`` fires before the socket
        is touched: a partition loses the frame without tearing the
        link down (the peer looks alive-but-unreachable)."""
        if self._fault is not None:
            self._fault("peer_partition")
        if connect_timeout is None:
            connect_timeout = min(2.0, max(0.5, self.cfg.gossip_s))
        with peer.lock:
            sock = peer.sock
            if sock is None:
                sock = socket.create_connection(peer.addr,
                                                timeout=connect_timeout)
                sock.settimeout(None)
                try:
                    sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                                    struct.pack("ll", 5, 0))
                except OSError:
                    pass
                peer.sock = sock
                threading.Thread(target=self._link_reader,
                                 args=(peer, sock), daemon=True,
                                 name=f"gofr-fed-link-{peer.host_id}").start()
            try:
                if payload is not None:
                    send_bytes(sock, payload, fault=self._fault)
                else:
                    send_frame(sock, obj, fault=self._fault)
            except Exception:
                peer.send_errors += 1
                self._close_link_locked(peer)
                raise

    @staticmethod
    def _close_link_locked(peer: _Peer) -> None:
        if peer.sock is not None:
            try:
                peer.sock.close()
            except OSError:
                pass
            peer.sock = None

    def _link_reader(self, peer: _Peer, sock: socket.socket) -> None:
        """Response dispatcher for one outbound link: every frame the
        peer sends back routes to its stream's queue. Reader death (EOF,
        reset, injected ``peer_recv``) fails every in-flight stream —
        their consumers fall back locally or surface typed errors."""
        try:
            while True:
                frame = recv_frame(sock, fault=self._fault)
                if frame is None:
                    break
                if self._fault is not None:
                    try:
                        self._fault("peer_partition")
                    except Exception:
                        continue  # partitioned: the frame never arrived
                if isinstance(frame, dict):
                    self._dispatch_to_stream(peer, frame)
        except Exception:
            pass
        finally:
            with peer.lock:
                if peer.sock is sock:
                    self._close_link_locked(peer)
            self._fail_peer_streams(
                peer, f"link to federated host {peer.host_id!r} lost")

    @staticmethod
    def _dispatch_to_stream(peer: _Peer, frame: dict) -> None:
        entry = peer.streams.get(frame.get("id"))
        if entry is None:
            return
        loop, q = entry
        try:
            loop.call_soon_threadsafe(q.put_nowait, frame)
        except RuntimeError:
            pass  # consumer loop already closed; stream is abandoned

    def _fail_peer_streams(self, peer: _Peer, msg: str) -> None:
        streams = list(peer.streams.values())
        peer.streams.clear()
        for loop, q in streams:
            try:
                loop.call_soon_threadsafe(
                    q.put_nowait, {"error": msg, "etype": _ETYPE_CONN})
            except RuntimeError:
                pass

    # -- membership: gossip out, liveness sweep ------------------------------
    def _digest_summary(self) -> list[list]:
        """``[prefix_len, token_digest]`` rows of the hottest local
        prefixes — what peers match prompts against for remote
        affinity."""
        rows: list[list] = []
        seen: set[tuple] = set()

        def _add(ids) -> None:
            toks = [int(t) for t in ids]
            key = tuple(toks)
            if toks and key not in seen:
                seen.add(key)
                rows.append([len(toks), token_digest(toks)])

        limit = self.cfg.digest_limit
        if hasattr(self.local, "hot_prefix_rows"):        # ReplicaPool
            for row in self.local.hot_prefix_rows(limit):
                _add(row["ids"])
        else:                                             # bare LLMServer
            cache = getattr(self.local, "prefix_cache", None)
            if cache is not None:
                for row in cache.hot_prefixes(limit):
                    _add(row["ids"])
        return rows[:limit]

    def _warm_now(self) -> bool:
        """Routable-for-peers: local health is live AND the pin backfill
        happened (or nobody sent one within a grace window — an empty
        fleet must not deadlock waiting for pins that never come)."""
        if self._leaving or self._closed:
            return False
        try:
            if self.local.health() == "dead":
                return False
        except Exception:
            return False
        return (self._pins_synced
                or time.monotonic() - self._boot > 5 * self.cfg.gossip_s)

    def _gossip_frame(self) -> dict:
        try:
            health = self.local.health()
        except Exception:
            health = "dead"
        try:
            queued = int(self.local.queue_depth())
        except Exception:
            queued = 0
        frame = {"op": _OP_GOSSIP, "host": self.cfg.host_id,
                 "health": health, "queued": queued,
                 "warm": self._warm_now(),
                 "digests": self._digest_summary()}
        if self._leaving:
            frame["leaving"] = True
        return frame

    def _gossip_loop(self) -> None:
        while not self._closed:
            self._wake.wait(self.cfg.gossip_s)
            if self._closed:
                return
            frame = self._gossip_frame()
            for peer in self._peers.values():
                if peer.state == "left":
                    continue
                try:
                    self._link_send(peer, frame)
                except Exception:
                    pass  # counted on the peer; liveness decides the rest
            self._sweep_liveness()

    def _sweep_liveness(self) -> None:
        now = time.monotonic()
        suspects: list[_Peer] = []
        deaths: list[_Peer] = []
        with self._lock:
            for peer in self._peers.values():
                if peer.last_beat is None or peer.state in ("dead", "left"):
                    continue
                gap = now - peer.last_beat
                if gap > self.cfg.dead_after_s():
                    peer.state = "dead"
                    deaths.append(peer)
                elif gap > self.cfg.suspect_after_s() \
                        and peer.state == "up":
                    peer.state = "suspect"
                    suspects.append(peer)
        for peer in suspects:
            self._events.emit("peer_suspect", model=self.name,
                              host=peer.host_id,
                              missed_s=round(now - peer.last_beat, 3))
        for peer in deaths:
            self._events.emit("peer_dead", model=self.name,
                              host=peer.host_id,
                              missed_s=round(now - peer.last_beat, 3))
            self._log(f"federated host {peer.host_id!r} declared dead")
            with peer.lock:
                self._close_link_locked(peer)
            # its queued work re-admits on survivors: failing the
            # streams sends every not-yet-yielded consumer down the
            # local front-of-class fallback path
            self._fail_peer_streams(
                peer, f"federated host {peer.host_id!r} dead "
                      f"(missed {self.cfg.dead_beats} beats)")

    # -- inbound: accept loop, frame dispatch, remote serving ----------------
    def _accept_loop(self) -> None:
        while True:
            try:
                sock, _addr = self._server.accept()
            except OSError:
                return  # listener closed
            conn = _FedConn(sock, fault=self._fault)
            with self._lock:
                if self._closed:
                    conn.close()
                    try:
                        sock.close()
                    except OSError:
                        pass
                    return
                self._inbound.add(conn)
            threading.Thread(target=self._inbound_loop, args=(conn,),
                             daemon=True, name="gofr-fed-inbound").start()

    def _inbound_loop(self, conn: _FedConn) -> None:
        tasks: dict = {}  # rid -> concurrent.futures.Future
        try:
            while True:
                frame = recv_frame(conn.sock, fault=self._fault)
                if frame is None:
                    break
                if self._fault is not None:
                    try:
                        self._fault("peer_partition")
                    except Exception:
                        continue  # partitioned: inbound frame dropped
                if isinstance(frame, bytes):
                    self._land_migration(frame)
                    continue
                if not isinstance(frame, dict):
                    continue
                op = frame.get("op")
                if op == _OP_GOSSIP:
                    self._on_gossip(frame)
                elif op == _OP_GEN:
                    try:
                        fut = asyncio.run_coroutine_threadsafe(
                            self._serve_remote(conn, frame),
                            self._serve_loop)
                        tasks[frame.get("id")] = fut
                    except RuntimeError:
                        conn.send({"id": frame.get("id"),
                                   "error": "serving loop stopped",
                                   "etype": "ServerClosed"})
                elif op == _OP_CANCEL:
                    fut = tasks.pop(frame.get("id"), None)
                    if fut is not None:
                        fut.cancel()
                elif op == _OP_PIN:
                    self._on_pin(frame)
                elif op == _OP_LEAVE:
                    self._on_leave(frame)
        except Exception:
            pass
        finally:
            for fut in tasks.values():
                fut.cancel()
            with self._lock:
                self._inbound.discard(conn)
            conn.close()
            try:
                conn.sock.close()
            except OSError:
                pass

    def _on_gossip(self, frame: dict) -> None:
        peer = self._peers.get(frame.get("host"))
        if peer is None:
            return  # static membership: unknown hosts never join
        if frame.get("leaving"):
            # a leaving host keeps beating while it drains local traffic:
            # the beat must pin it ``left`` (never resurrect it to
            # routable), and it covers a lost leave frame
            with self._lock:
                prev = peer.state
                peer.last_beat = time.monotonic()
                peer.beats += 1
                peer.health = frame.get("health")
                peer.warm = False
                peer.digests = []
                peer.state = "left"
            if prev != "left":
                self._events.emit("host_leave", model=self.name,
                                  host=peer.host_id)
                self._log(f"federated host {peer.host_id!r} left the fleet")
            return
        with self._lock:
            prev = peer.state
            peer.last_beat = time.monotonic()
            peer.beats += 1
            peer.health = frame.get("health")
            try:
                peer.queued = int(frame.get("queued", 0) or 0)
            except (TypeError, ValueError):
                peer.queued = 0
            peer.warm = bool(frame.get("warm"))
            digests = []
            for row in frame.get("digests", [])[:64]:
                try:
                    length, digest = row
                    digests.append((int(length), str(digest)))
                except (TypeError, ValueError):
                    continue
            peer.digests = digests
            peer.state = "up"
        if prev in ("unknown", "dead", "left"):
            self._events.emit("host_join", model=self.name,
                              host=peer.host_id, prev_state=prev)
            self._events.emit("peer_up", model=self.name, host=peer.host_id)
            self._log(f"federated host {peer.host_id!r} joined ({prev})")
            # backfill the joiner: our pinned prefixes, so it warms
            # before taking traffic (an empty pin set still counts as
            # the warm handshake)
            threading.Thread(target=self._send_pins, args=(peer,),
                             daemon=True, name="gofr-fed-pinsync").start()
        elif prev == "suspect":
            self._events.emit("peer_up", model=self.name,
                              host=peer.host_id, recovered=True)

    def _send_pins(self, peer: _Peer) -> None:
        prefixes: list[list[int]] = []
        try:
            if hasattr(self.local, "pinned_prefix_tokens"):
                prefixes = self.local.pinned_prefix_tokens(
                    self.cfg.pin_limit)
        except Exception:
            prefixes = []
        try:
            self._link_send(peer, {"op": _OP_PIN, "host": self.cfg.host_id,
                                   "prefixes": prefixes})
        except Exception:
            pass  # the joiner's grace window covers a lost pin frame

    def _on_pin(self, frame: dict) -> None:
        prefixes = frame.get("prefixes") or []

        def _apply() -> None:
            for ids in prefixes[:self.cfg.pin_limit]:
                try:
                    self.local.register_prefix([int(t) for t in ids])
                except Exception:
                    pass  # a failed backfill just costs a later prefill
            self._pins_synced = True

        if prefixes:
            threading.Thread(target=_apply, daemon=True,
                             name="gofr-fed-pin-apply").start()
        else:
            self._pins_synced = True

    def _on_leave(self, frame: dict) -> None:
        peer = self._peers.get(frame.get("host"))
        if peer is None:
            return
        with self._lock:
            peer.state = "left"
            peer.warm = False
        self._events.emit("host_leave", model=self.name, host=peer.host_id)
        self._log(f"federated host {peer.host_id!r} left the fleet")

    def _land_migration(self, raw: bytes) -> None:
        """A leaving peer's hot subtree arrives as a binary frame: land
        it in a live local core's host tier (+ radix adoption). The
        ``land_bytes`` outcome closes the fleet-wide migration ledger
        receiver-side."""
        core = None
        if self._local_is_pool:
            for i in getattr(self.local, "_live_indices", lambda: [])():
                candidate = self.local.replicas[i]
                if candidate.health() != "dead":
                    core = candidate
                    break
        else:
            core = self.local
        if core is None:
            self._transport.account_lost_migration()
            return
        try:
            self._transport.land_bytes(core, raw)
        except Exception:
            pass  # land_bytes accounts its own failures

    async def _serve_remote(self, conn: _FedConn, frame: dict) -> None:
        """Drive one peer request through the local server, streaming
        bursts back as ``{"id", "tokens"}`` frames. The frame's
        traceparent parents the serving span, so the request is ONE
        trace across the socket."""
        rid = frame.get("id")
        span = None
        if self._tracer is not None:
            span = self._tracer.start_span(
                "ml.fed.serve", parent=parse_traceparent(
                    frame.get("traceparent")),
                kind="SERVER", activate=True,
                attributes={"ml.model": self.name,
                            "ml.fed.host": self.cfg.host_id})
        agen = None
        try:
            tokens = [int(t) for t in frame.get("tokens", [])]
            max_new = int(frame.get("max_new", 16))
            with self._lock:
                self.remote_served += 1
            agen = self.local.stream_chunks(
                tokens, max_new, priority=frame.get("priority"),
                deadline_s=frame.get("deadline_s"))
            async for burst in agen:
                if not conn.alive:
                    return
                conn.send({"id": rid, "tokens": [int(t) for t in burst]})
            conn.send({"id": rid, "done": True})
        except asyncio.CancelledError:
            raise
        except Exception as exc:
            conn.send({"id": rid, "error": str(exc)[:300],
                       "etype": type(exc).__name__})
            if span is not None:
                span.set_status("ERROR", str(exc)[:200])
        finally:
            if agen is not None:
                try:
                    await agen.aclose()
                except Exception:
                    pass
            if span is not None:
                span.end()

    # -- remote routing (the client side) ------------------------------------
    def _routable(self, peer: _Peer) -> bool:
        return (peer.state == "up" and peer.warm
                and peer.health in ("serving", "degraded"))

    def _local_match_len(self, prompt: list[int]) -> int:
        best = 0
        cores = (self.local.replicas if self._local_is_pool
                 else [self.local])
        for core in cores:
            cache = getattr(core, "prefix_cache", None)
            if cache is None:
                continue
            try:
                pid, length = cache.peek(prompt)
            except Exception:
                continue
            if pid is not None and length > best:
                best = length
        return best

    def _route_remote(self, prompt: list[int]) -> _Peer | None:
        """Pick a peer whose gossiped digest summary matches this prompt
        DEEPER than any local radix hit (and past the affinity floor) —
        otherwise None and the local path wins. Pure function of
        gossiped state: no wire traffic, so a dead fleet costs routing
        nothing."""
        if not self._peers:
            return None
        n = len(prompt)
        best: _Peer | None = None
        best_len = 0
        for peer in self._peers.values():
            if not self._routable(peer):
                continue
            for length, digest in peer.digests:
                if (self.cfg.affinity_min_tokens <= length <= n
                        and length > best_len
                        and token_digest(prompt[:length]) == digest):
                    best, best_len = peer, length
        if best is None:
            return None
        if best_len <= self._local_match_len(prompt):
            return None  # the local trie already holds as much
        try:
            local_queued = int(self.local.queue_depth())
        except Exception:
            local_queued = 0
        if best.queued > local_queued + 8:
            return None  # a hot prefix on a drowning peer is not a win
        return best

    async def _remote_stream(self, peer: _Peer, rid: str,
                             prompt: list[int], max_new: int,
                             priority, deadline_s) -> AsyncIterator[list]:
        """One remote generation attempt. Every wait is bounded by the
        liveness deadline; any peer-side loss raises ``_RemoteFailed``,
        a relayed typed error re-raises typed."""
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()
        peer.streams[rid] = (loop, q)
        frame: dict = {"op": _OP_GEN, "id": rid, "tokens": prompt,
                       "max_new": int(max_new)}
        if priority is not None:
            frame["priority"] = priority
        if deadline_s is not None:
            frame["deadline_s"] = deadline_s
        tp = current_traceparent()
        if tp is not None:
            frame["traceparent"] = tp
        finished = False
        try:
            try:
                await asyncio.to_thread(self._link_send, peer, frame)
            except Exception as exc:
                finished = True
                raise _RemoteFailed(
                    f"send to federated host {peer.host_id!r} failed "
                    f"({exc})") from exc
            while True:
                try:
                    msg = await asyncio.wait_for(
                        q.get(), timeout=self.cfg.frame_gap_s)
                except asyncio.TimeoutError:
                    finished = True
                    raise _RemoteFailed(
                        f"federated host {peer.host_id!r} silent past "
                        f"the liveness deadline "
                        f"({self.cfg.frame_gap_s:.1f}s)") from None
                if "error" in msg:
                    finished = True
                    etype = msg.get("etype")
                    err = str(msg["error"])
                    typed = _TYPED_REMOTE.get(etype)
                    if typed is not None:
                        raise typed(err)
                    # conn losses, remote crashes/closes/overload all
                    # take the local fallback (Overloaded remotely may
                    # still succeed locally; local admission re-sheds
                    # typed if the survivor is drowning too)
                    raise _RemoteFailed(
                        f"federated host {peer.host_id!r}: {err}")
                if msg.get("done"):
                    finished = True
                    return
                yield [int(t) for t in msg.get("tokens", [])]
        finally:
            peer.streams.pop(rid, None)
            if not finished:
                # abandoned mid-stream: free the peer's slot
                threading.Thread(
                    target=self._send_cancel, args=(peer, rid),
                    daemon=True, name="gofr-fed-cancel").start()

    def _send_cancel(self, peer: _Peer, rid: str) -> None:
        try:
            self._link_send(peer, {"op": _OP_CANCEL, "id": rid})
        except Exception:
            pass

    # -- the serving API -----------------------------------------------------
    async def stream_chunks(self, prompt_ids, max_new_tokens: int = 64,
                            prefix: int | None = None,
                            info: dict | None = None,
                            priority: int | str | None = None,
                            deadline_s: float | None = None,
                            mode: str = "chunks",
                            ) -> AsyncIterator[list[int]]:
        """The federated ``stream_chunks``: route to a peer when its
        gossiped digests beat the local trie, else (and on any remote
        loss before the first token) the local path — bit-identically.
        Pinned-prefix requests (``prefix=``) are always local: the pin
        lives on every local replica."""
        if self._closed:
            raise ServerClosed(f"federated pool {self.name!r} closed")
        prompt = [int(t) for t in prompt_ids]
        peer = None if prefix is not None else self._route_remote(prompt)
        if peer is None:
            # single-host path: delegate untouched (same generator
            # object, same admission, same output)
            agen = self.local.stream_chunks(
                prompt, max_new_tokens, prefix=prefix, info=info,
                priority=priority, deadline_s=deadline_s, mode=mode)
            try:
                async for burst in agen:
                    yield burst
            finally:
                await agen.aclose()
            return
        rid = next_rid()
        with self._lock:
            self.remote_routed += 1
            peer.remote_routed += 1
        self._count("app_llm_fed_remote_routed_total", host=peer.host_id)
        self._events.emit("route", model=self.name, rid=rid,
                          host=peer.host_id, reason="fed_affinity")
        journey = None
        if self._journeys is not None:
            ctx = current_context()
            journey = self._journeys.start(Journey(
                rid, model=self.name,
                trace_id=ctx.trace_id if ctx is not None else None))
            journey.mark("route", replica=f"fed:{peer.host_id}",
                         reason="fed_affinity", attempt=0)
        t0 = time.monotonic()
        yielded = False
        try:
            agen = self._remote_stream(peer, rid, prompt, max_new_tokens,
                                       priority, deadline_s)
            try:
                async for burst in agen:
                    if journey is not None:
                        journey.mark("prefill" if not yielded else "decode",
                                     tokens=len(burst))
                    yielded = True
                    yield burst
            finally:
                await agen.aclose()
            seal(journey, "stop", log=self._journeys,
                 metrics=self._metrics)
            return
        except _RemoteFailed as exc:
            if yielded:
                # mid-stream loss: same contract as a replica crash
                # after first token — the stream cannot resume
                seal(journey, "crashed", str(exc), log=self._journeys,
                     metrics=self._metrics)
                raise GeneratorCrashed(
                    f"federated stream lost mid-generation ({exc})"
                ) from exc
            with self._lock:
                self.remote_failovers += 1
            self._count("app_llm_fed_remote_failovers_total")
            self._events.emit("failover", model=self.name, rid=rid,
                              from_host=peer.host_id, where="federation")
            if self._goodput is not None:
                # the fleet may have paid the remote prefill and will
                # now pay it again locally: charge the recompute
                self._goodput.note(self.name, "federation_recompute",
                                   len(prompt))
            seal(journey, "error", f"fed failover: {exc}",
                 log=self._journeys, metrics=self._metrics)
        except (DeadlineExceeded, ValueError):
            seal(journey, "error", "typed remote error",
                 log=self._journeys, metrics=self._metrics)
            raise
        except GeneratorExit:
            seal(journey, "cancelled", log=self._journeys,
                 metrics=self._metrics)
            raise
        except Exception as exc:
            seal(journey, "error", str(exc)[:200], log=self._journeys,
                 metrics=self._metrics)
            raise
        # local fallback, front-of-class: the request already waited its
        # turn on the remote attempt
        remaining = deadline_s
        if deadline_s:
            remaining = max(0.001, deadline_s - (time.monotonic() - t0))
        kwargs: dict = dict(info=info, priority=priority,
                            deadline_s=remaining, mode=mode)
        if self._local_is_pool:
            kwargs["front"] = True
        agen = self.local.stream_chunks(prompt, max_new_tokens, **kwargs)
        try:
            async for burst in agen:
                yield burst
        finally:
            await agen.aclose()

    async def stream(self, prompt_ids, max_new_tokens: int = 64,
                     **kwargs) -> AsyncIterator[int]:
        agen = self.stream_chunks(prompt_ids, max_new_tokens, **kwargs)
        try:
            async for burst in agen:
                for tok in burst:
                    yield tok
        finally:
            await agen.aclose()

    async def generate(self, prompt_ids, max_new_tokens: int = 64,
                       **kwargs) -> list[int]:
        out: list[int] = []
        async for burst in self.stream_chunks(prompt_ids, max_new_tokens,
                                              **kwargs):
            out.extend(burst)
        return out

    # -- host leave (graceful departure) -------------------------------------
    def leave(self) -> dict:
        """Begin a graceful departure: live-migrate the hot subtrees to
        the least-loaded warm survivor over ``migrate_bytes`` frames,
        announce the leave, and stop advertising warm — peers stop
        routing here while local traffic keeps draining until
        ``close()``. Returns the migration tally."""
        with self._lock:
            if self._leaving:
                return {"already_leaving": True}
            self._leaving = True
        target = None
        with self._lock:
            candidates = [p for p in self._peers.values()
                          if self._routable(p)]
        if candidates:
            target = min(candidates, key=lambda p: p.queued)
        shipped = lost = 0
        if target is not None:
            cores = (
                [self.local.replicas[i]
                 for i in getattr(self.local, "_live_indices",
                                  lambda: [])()]
                if self._local_is_pool else [self.local])
            for core in cores:
                cache = getattr(core, "prefix_cache", None)
                if cache is None:
                    continue
                for row in cache.hot_prefixes(self.cfg.digest_limit):
                    raw = self._transport.migrate_bytes(
                        core, row["ids"], row.get("pid"))
                    if raw is None:
                        continue
                    try:
                        self._link_send(target, payload=raw)
                        shipped += 1
                    except Exception:
                        # the export counted a ship nobody will land:
                        # close the fleet ledger sender-side
                        self._transport.account_lost_migration()
                        lost += 1
        leave_frame = {"op": _OP_LEAVE, "host": self.cfg.host_id}
        for peer in self._peers.values():
            if peer.state == "left":
                continue
            try:
                self._link_send(peer, leave_frame)
            except Exception:
                pass
        self._events.emit("host_leave", model=self.name,
                          host=self.cfg.host_id, local=True,
                          migrated=shipped, lost_frames=lost,
                          to_host=target.host_id if target else None)
        self._log(f"federated host {self.cfg.host_id!r} leaving "
                  f"(migrated {shipped} subtrees)")
        return {"migrated": shipped, "lost_frames": lost,
                "target": target.host_id if target else None}

    # -- observability / datasource contract ---------------------------------
    def queue_depth(self) -> int:
        inflight = sum(len(p.streams) for p in self._peers.values())
        try:
            return int(self.local.queue_depth()) + inflight
        except Exception:
            return inflight

    def health(self) -> str:
        """``serving`` — local serving and every peer up (or cleanly
        left); ``degraded`` — SOME host is down/suspect/unseen or local
        capacity is reduced; ``dead`` — every host is: the local server
        is dead AND no peer is reachable."""
        if self._closed:
            return "dead"
        try:
            local = self.local.health()
        except Exception:
            local = "dead"
        states = [p.state for p in self._peers.values()]
        any_peer_alive = any(s in ("up", "suspect") for s in states)
        if local == "dead":
            return "degraded" if any_peer_alive else "dead"
        if local != "serving":
            return "degraded"
        if any(s in ("unknown", "suspect", "dead") for s in states):
            return "degraded"
        return "serving"

    def health_check(self) -> dict:
        state = self.health()
        status = {"serving": "UP", "degraded": "DEGRADED",
                  "dead": "DOWN"}[state]
        try:
            local = self.local.health_check()
        except Exception as exc:
            local = {"status": "DOWN", "details": {"error": str(exc)[:200]}}
        return {
            "status": status,
            "details": {
                "model": self.name,
                "state": state,
                "host": self.cfg.host_id,
                "hosts": {hid: p.row() for hid, p in self._peers.items()},
                "local": local.get("details", local),
            },
        }

    def federation_snapshot(self) -> dict:
        """The ``federation`` block of ``/debug/serving``: this host's
        identity and knobs, one row per peer, the remote-plane counters,
        and the cross-host migration ledger."""
        with self._lock:
            peers = {hid: p.row() for hid, p in self._peers.items()}
        return {
            "host": self.cfg.host_id,
            "listen": f"{self.listen_addr[0]}:{self.listen_addr[1]}",
            "state": self.health(),
            "warm": self._warm_now(),
            "leaving": self._leaving,
            "gossip_s": self.cfg.gossip_s,
            "suspect_beats": self.cfg.suspect_beats,
            "dead_beats": self.cfg.dead_beats,
            "frame_gap_s": self.cfg.frame_gap_s,
            "affinity_min_tokens": self.cfg.affinity_min_tokens,
            "hosts": peers,
            "remote": {"routed": self.remote_routed,
                       "served": self.remote_served,
                       "failovers": self.remote_failovers},
            "migrations": dict(self._transport.migrations),
            "fault": fault_snapshot(self._fault),
        }

    def routing_snapshot(self) -> dict:
        base: dict = {}
        if hasattr(self.local, "routing_snapshot"):
            base = dict(self.local.routing_snapshot())
        base["federation"] = self.federation_snapshot()
        return base

    def export_gauges(self, metrics) -> None:
        if hasattr(self.local, "export_gauges"):
            self.local.export_gauges(metrics)
        order = {"up": 0, "suspect": 1, "dead": 2, "left": 3, "unknown": 4}
        for hid, peer in self._peers.items():
            try:
                metrics.set_gauge("app_llm_fed_peer_state",
                                  order.get(peer.state, 4),
                                  model=self.name, host=hid)
            except Exception:
                pass

    # -- shutdown ------------------------------------------------------------
    def close(self, *args, **kwargs) -> None:
        """Tear the federation plane down, then the local server. Abrupt
        by design — a graceful departure is ``leave()`` first. Never
        hangs: sockets close, streams fail typed, bounded joins only."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            inbound = list(self._inbound)
            self._inbound.clear()
        self._wake.set()
        try:
            self._server.close()
        except OSError:
            pass
        for conn in inbound:
            conn.close()
            try:
                conn.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.sock.close()
            except OSError:
                pass
        for peer in self._peers.values():
            with peer.lock:
                self._close_link_locked(peer)
            self._fail_peer_streams(
                peer, f"federated pool {self.name!r} closed")
        self._gossip_thread.join(timeout=2.0)
        # give inbound serve tasks one beat to observe their cancelled
        # futures before the loop stops running callbacks
        time.sleep(0.05)
        try:
            self._serve_loop.call_soon_threadsafe(self._serve_loop.stop)
        except RuntimeError:
            pass
        self.local.close(*args, **kwargs)
