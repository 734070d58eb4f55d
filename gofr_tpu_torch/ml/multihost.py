"""Multi-host serving — counterpart of ``gofr_tpu/ml/multihost.py``: a
front-end process owning the HTTP/gRPC ports, backed by an N-process
``torch.distributed`` mesh of continuous-batching Generators in lock-step,
over the same model-port wire.

**The wire.** Two frame types share one socket, distinguished by the top
bit of the 4-byte big-endian length prefix:

- JSON frames (bit clear): ``send_frame`` writes ``json.dumps(obj)``;
- BINARY frames (bit set, ``send_bytes``): the payload is raw bytes. KV
  page slabs ride these (``ml/kv_transport.py``), where base64 inside a
  JSON frame would cost a third more on the wire and a copy each side.

The flag bit caps one frame at 2 GiB. ``recv_frame`` returns parsed JSON
for a JSON frame, ``bytes`` for a binary one and ``None`` on EOF, so a
frame written by either package reads in the other. Each call takes an
optional chaos hook (``testutil/faults.py``): ``peer_send`` fires before
the bytes hit the wire and ``peer_recv`` before the header read, so an
injected fault looks exactly like a torn connection.

**The mesh** (``MultiHostWorker``, one process a rank). The ranks form a
``torch.distributed`` group over ``gloo``: only host data crosses it, so
no NCCL is needed and two ranks may share one card. Each rank runs on
``cuda:{rank % device_count}`` and holds its own ``Generator`` over
``batch_slots / world`` slots — the port's counterpart of JAX's one
Generator whose slots shard over ``dp``. Rank 0 owns the global slot
table:

- it decides, and broadcasts each command as a fixed-shape int32 frame
  (STOP / ADMIT / STEP / CANCEL / NOOP, CANCEL in global slots); every
  rank replays it on its own Generator. An ADMIT row names the rank that
  admits it (rank 0 places every row by the ranks' free slots), so
  followers never decide;
- after each ADMIT or STEP one ``gather`` of a fixed-shape int32 block a
  rank brings rank 0 every slot's news: the request's tag, its local
  slot, whether it is done, and its new tokens, padded to
  ``(chunk + 1) × (spec_k + 1)`` (a longer backlog waits for the next
  gather). This takes the place of the SPMD program's replicated token
  blocks;
- idle periods are bridged by NOOP heartbeats, so followers never sit in
  a collective past its timeout;
- rank 0 serves a TCP model port of length-prefixed JSON frames,
  multiplexed: each request carries a client-chosen ``id``, and bursts
  ride ``{"id": n, "tokens": [...]}`` frames.

Failure semantics are JAX's: a failed collective or device op on rank 0
answers every stream with the typed error frame, then broadcasts STOP and
tears the mesh down rather than leaving followers parked in a collective
that can never pair. Every collective is bounded by the group's timeout,
and a killed rank breaks its peers' sockets at once, so a lost rank
surfaces as an error, never as a hang. A ``stop`` frame makes rank 0
broadcast STOP; every rank exits its loop. A front-end disconnect only
cancels that connection's requests.

Tensor parallelism within a rank: ``device=[a, b, ...]`` splits the
rank's model over those devices (a tp mesh of them, the weights split by
``llama.SHARDING_RULES``, the cache by KV head), as JAX's ``(dp, tp)``
mesh splits it over a host's chips. What differs (ROADMAP C): JAX runs one
SPMD Generator over the whole ``(dp = processes, tp = local chips)`` mesh;
here each rank keeps its own Generator over its slots (``dp`` stays across
ranks) with its ``tp`` inside it, and loads its own copy of the weights.

The front end (``MultiHostLLMClient``) is pure asyncio and never touches
torch: one multiplexed connection, one reader task, a retry budget of one
before the first token, and a liveness deadline between frames.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import queue as _queue
import socket
import struct
import threading
import time
from typing import Any, AsyncIterator, Iterable

from ..tracing import current_traceparent, parse_traceparent
from .errors import GeneratorCrashed, ServerClosed

__all__ = ["MultiHostWorker", "MultiHostLLMClient", "send_frame",
           "recv_frame", "send_bytes"]

_OP_STOP = 0
_OP_ADMIT = 1
_OP_STEP = 2
_OP_CANCEL = 3
_OP_NOOP = 4  # heartbeat: keeps followers' broadcast wait from timing out

# error-frame sentinels: the model-port protocol carries only an "error"
# text field, so the client's typed-error mapping and the worker's emit
# sites share these literals (JAX's, byte for byte)
_ERR_CONN_LOST = "model connection lost"
_ERR_STOPPED = "server stopped"

_BIN_FLAG = 0x8000_0000

# a gathered row: tag, local slot, done flag, token count, then the tokens
_ROW_HEAD = 4

# the rendezvous and every rank's weight load and warmup fit in this
_BOOT_TIMEOUT_S = 600.0


def send_frame(sock: socket.socket, obj: Any, fault=None) -> None:
    """Send one JSON frame."""
    if fault is not None:
        fault("peer_send")
    raw = json.dumps(obj).encode()
    sock.sendall(struct.pack(">I", len(raw)) + raw)


def send_bytes(sock: socket.socket, payload: bytes, fault=None) -> None:
    """Send one raw-bytes frame (received as ``bytes`` by ``recv_frame``)."""
    if fault is not None:
        fault("peer_send")
    if len(payload) >= _BIN_FLAG:
        raise ValueError(
            f"binary frame too large ({len(payload)} bytes; max 2 GiB)")
    sock.sendall(struct.pack(">I", _BIN_FLAG | len(payload)) + payload)


def recv_frame(sock: socket.socket, fault=None) -> Any | None:
    """One frame: parsed JSON for a JSON frame, ``bytes`` for a binary
    frame, ``None`` on EOF."""
    if fault is not None:
        fault("peer_recv")
    header = _recv_exact(sock, 4)
    if header is None:
        return None
    (size,) = struct.unpack(">I", header)
    body = _recv_exact(sock, size & ~_BIN_FLAG)
    if body is None:
        return None
    if size & _BIN_FLAG:
        return body
    return json.loads(body)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


class _Conn:
    """One front-end connection on rank 0: frame writes go through a
    bounded queue drained by a writer thread, so the lock-step drive loop
    never blocks on a client's TCP backpressure. Queue overflow (a client
    that cannot keep up with its own stream) kills the connection; the
    drive loop then cancels its requests like any other disconnect."""

    __slots__ = ("sock", "alive", "_q", "_writer")

    _Q_CAP = 256  # bursts; overflow == client hopelessly behind

    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        self.alive = True
        self._q: "_queue.Queue" = _queue.Queue(maxsize=self._Q_CAP)
        # SO_SNDTIMEO: the writer thread itself cannot hang on a dead peer
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                            struct.pack("ll", 10, 0))
        except OSError:
            pass
        self._writer = threading.Thread(target=self._drain, daemon=True,
                                        name="gofr-mh-conn-writer")
        self._writer.start()

    def _drain(self) -> None:
        while True:
            obj = self._q.get()
            try:
                if obj is None or not self.alive:
                    return
                try:
                    send_frame(self.sock, obj)
                except OSError:
                    self.alive = False
                    return
            finally:
                # after the send: flush() waits on the unfinished-task
                # count, so a frame popped but not yet written still counts
                self._q.task_done()

    def send(self, obj: Any) -> None:
        """Non-blocking enqueue; a dead or overflowing connection flips
        ``alive`` and the drive loop cancels its requests."""
        if not self.alive:
            return
        try:
            self._q.put_nowait(obj)
        except _queue.Full:
            self.alive = False
            try:  # unblock the writer stuck on the slow peer
                self.sock.shutdown(socket.SHUT_WR)
            except OSError:
                pass

    def close(self) -> None:
        """Mark dead and wake the writer thread so it exits."""
        self.alive = False
        try:
            self._q.put_nowait(None)
        except _queue.Full:
            pass  # the writer checks ``alive`` per frame

    def flush(self, timeout_s: float = 5.0) -> None:
        """Best-effort wait for queued frames to reach the socket, so the
        final ``stopped`` / error frames are not cut by a teardown
        ``close()``."""
        deadline = time.monotonic() + timeout_s
        while self.alive and self._q.unfinished_tasks:
            if time.monotonic() >= deadline:
                return
            time.sleep(0.005)


class _Tag:
    """A rank's view of one admitted request: its local slot, the tokens
    not yet gathered, and whether the slot has finished."""

    __slots__ = ("slot", "buf", "finished")

    def __init__(self, slot: int) -> None:
        self.slot = slot
        self.buf: list[int] = []
        self.finished = False


class MultiHostWorker:
    """One rank of the serving mesh. ``run()`` blocks for the process
    lifetime (``setup()`` then ``serve()``); rank 0 also serves the model
    port. ``device`` defaults to ``cuda:{process_id % device_count}``;
    without a card it raises unless ``device="cpu"``. A list of devices
    makes the rank tensor-parallel over them (the first holds the
    activations)."""

    def __init__(self, process_id: int, num_processes: int,
                 coordinator: str, *, port: int = 0, cfg=None, seed: int = 0,
                 batch_slots: int | None = None, max_seq: int | None = None,
                 prefill_buckets: tuple = (), prompt_bucket: int | None = None,
                 chunk: int = 4, sampler=None, eos_id: int | None = None,
                 spec_k: int = 0, prefill_chunk: int = 0,
                 heartbeat_s: float = 5.0,
                 logger=None, tracer=None, device=None) -> None:
        if not 0 <= process_id < num_processes:
            raise ValueError(
                f"process_id must be in [0, {num_processes}), got "
                f"{process_id}")
        self.process_id = process_id
        self.num_processes = num_processes
        self.coordinator = coordinator
        self.port = port
        self.seed = seed
        self.chunk = chunk
        self.sampler = sampler
        self.eos_id = eos_id
        self.spec_k = spec_k
        # segmented prefill in lock-step: every rank advances its segments
        # inside the broadcast STEP
        self.prefill_chunk = prefill_chunk
        self.heartbeat_s = heartbeat_s
        self.batch_slots = batch_slots
        self.max_seq = max_seq
        self.prefill_buckets = tuple(prefill_buckets) or (
            (prompt_bucket,) if prompt_bucket else (32, 128))
        self._cfg = cfg
        self._logger = logger
        # optional rank-0 tracer: generate frames carry the front-end's
        # traceparent, so a mesh request is one span in the same trace
        self._tracer = tracer
        self._device_arg = device
        # every serving collective is bounded: past it a silent peer is an
        # error; idle followers hear a NOOP every ``heartbeat_s``
        self.timeout_s = max(60.0, 12 * heartbeat_s)
        self.stats = {"admits": 0, "steps": 0, "cancels": 0,
                      "gather_s": 0.0, "gathers": 0}

    # -- mesh + model setup ----------------------------------------------------
    def _resolve_devices(self) -> list:
        """The rank's devices: one, or the tp devices of a list."""
        dev = self._device_arg
        if isinstance(dev, (list, tuple)):
            if not dev:
                raise ValueError("device=[] names no device")
            from .. import resolve_device

            return [resolve_device(d) for d in dev]
        return [self._resolve_device()]

    def _resolve_device(self):
        import torch

        from .. import resolve_device

        dev = self._device_arg
        if isinstance(dev, (list, tuple)):
            return self._resolve_devices()[0]
        if dev is not None:
            return resolve_device(dev)
        if not torch.cuda.is_available():
            raise RuntimeError(
                "MultiHostWorker: no CUDA device: pass device='cpu' to run "
                "the rank on the host")
        return torch.device("cuda",
                            self.process_id % torch.cuda.device_count())

    def setup(self) -> None:
        """Join the process group, load the weights, build and warm the
        rank's Generator, then meet every rank once more."""
        from datetime import timedelta

        import numpy as np
        import torch
        import torch.distributed as dist

        from .. import parallel as par
        from ..models import llama
        from .generate import Generator

        devs = self._resolve_devices()
        dev = devs[0]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        self.device = dev
        dist.init_process_group(
            "gloo", init_method=f"tcp://{self.coordinator}",
            rank=self.process_id, world_size=self.num_processes,
            timeout=timedelta(seconds=_BOOT_TIMEOUT_S))
        self._dist = dist
        self._np = np
        self._torch = torch
        cfg = self._cfg or llama.config_from_env()
        self.cfg = cfg
        world = self.num_processes
        if self.batch_slots is None:
            self.batch_slots = 2 * world
        if self.batch_slots % world:
            raise ValueError(
                f"batch_slots ({self.batch_slots}) must split evenly over "
                f"{world} ranks")
        self.local_slots = self.batch_slots // world
        self.max_seq = self.max_seq or min(cfg.max_seq_len, 1024)
        self.bucket_cap = min(max(self.prefill_buckets), self.max_seq - 1)

        # LLAMA_CKPT names real weights; else random ones from ``seed``
        params = llama.params_from_config(cfg, seed=self.seed, device=dev)
        # tp spans the rank's devices (JAX's tp over a host's chips); dp
        # spans the ranks, one Generator each
        self.mesh = None
        if len(devs) > 1:
            self.mesh = par.make_mesh(par.MeshConfig(tp=len(devs)),
                                      devices=devs)
            params = par.shard_params(params, llama.sharding_specs(params),
                                      self.mesh)
        self.gen = Generator(
            params, cfg, batch_slots=self.local_slots, max_seq=self.max_seq,
            sampler=self.sampler, eos_id=self.eos_id,
            prefill_buckets=self.prefill_buckets, seed=self.seed,
            chunk=self.chunk, spec_k=self.spec_k,
            prefill_chunk=self.prefill_chunk, mesh=self.mesh,
            shard_cache=self.mesh is not None, device=dev)
        # build every kernel and capture every graph up front ON EVERY
        # RANK: a first-use capture inside the loop would stall one rank
        self.gen.warmup()
        # the serving group: the same ranks, a serving timeout; creating
        # it is the rendezvous after every rank's warmup
        self._pg = dist.new_group(backend="gloo",
                                  timeout=timedelta(seconds=self.timeout_s))
        self._cmd_len = 2 + self.batch_slots * (_ROW_HEAD + self.bucket_cap)
        self._cap = (self.chunk + 1) * (self.spec_k + 1)
        self._tags: dict[int, _Tag] = {}

    def _teardown(self) -> None:
        dist = getattr(self, "_dist", None)
        if dist is not None and dist.is_initialized():
            try:
                dist.destroy_process_group()
            except Exception:
                pass

    # -- command plane ---------------------------------------------------------
    def _broadcast(self, cmd):
        t = self._torch.from_numpy(cmd)
        self._dist.broadcast(t, src=0, group=self._pg)
        return t.numpy()

    def _zero_cmd(self, op: int = _OP_STOP):
        cmd = self._np.zeros((self._cmd_len,), self._np.int32)
        cmd[0] = op
        return cmd

    def _encode_admit(self, wave) -> Any:
        """wave: [(rank, tag, ids, max_new)] -> command frame."""
        np = self._np
        cmd = self._zero_cmd(_OP_ADMIT)
        cmd[1] = len(wave)
        stride = _ROW_HEAD + self.bucket_cap
        for row, (rank, tag, ids, max_new) in enumerate(wave):
            base = 2 + row * stride
            cmd[base:base + _ROW_HEAD] = (rank, tag, max_new, len(ids))
            cmd[base + _ROW_HEAD:base + _ROW_HEAD + len(ids)] = \
                np.asarray(ids, np.int32)
        return cmd

    def _decode_admit(self, cmd) -> list:
        stride = _ROW_HEAD + self.bucket_cap
        wave = []
        for row in range(int(cmd[1])):
            base = 2 + row * stride
            rank, tag, max_new, n = (int(v) for v in
                                     cmd[base:base + _ROW_HEAD])
            ids = [int(t) for t in
                   cmd[base + _ROW_HEAD:base + _ROW_HEAD + n]]
            wave.append((rank, tag, ids, max_new))
        return wave

    def _encode_cancel(self, rows) -> Any:
        """rows: [(global slot, tag)]. The tag tells a slot's new occupant
        from a finished one whose last tokens are not gathered yet."""
        cmd = self._zero_cmd(_OP_CANCEL)
        cmd[1] = len(rows)
        cmd[2:2 + 2 * len(rows)] = self._np.asarray(
            rows, self._np.int32).reshape(-1)
        return cmd

    # -- one rank's replay of a command ------------------------------------------
    def _reap(self) -> None:
        """Slots whose stream ended (their last burst is in the tag's
        buffer) return to the Generator's free pool. A slot still
        prefilling in segments is live: not done."""
        for tag in self._tags.values():
            if not tag.finished and not self.gen.slots[tag.slot].live:
                tag.finished = True
                self.gen.release(tag.slot)

    def _apply_admit(self, cmd) -> None:
        gen = self.gen
        # settle bookkeeping before slots are reused, in lock-step on
        # every rank (JAX: rank 0's drain before its admit)
        gen.drain()
        self._reap()
        mine = [(tag, ids, max_new) for rank, tag, ids, max_new
                in self._decode_admit(cmd) if rank == self.process_id]
        if not mine:
            return
        tags = self._tags

        def on_burst(tag_id):
            def cb(_slot, burst):
                entry = tags.get(tag_id)
                if entry is not None:  # a cancelled tag's late burst drops
                    entry.buf.extend(int(t) for t in burst)
            return cb

        slots = gen.add_requests([(ids, max_new, on_burst(tag))
                                  for tag, ids, max_new in mine])
        for (tag, _, _), slot in zip(mine, slots, strict=True):
            tags[tag] = _Tag(slot)

    def _apply_step(self) -> None:
        self.gen.step()
        self._reap()

    def _apply_cancel(self, cmd) -> None:
        base = self.process_id * self.local_slots
        rows = cmd[2:2 + 2 * int(cmd[1])].reshape(-1, 2)
        for gslot, tag_id in rows:
            if not base <= int(gslot) < base + self.local_slots:
                continue
            tag = self._tags.pop(int(tag_id), None)
            if tag is not None and not tag.finished:
                self.gen.slots[tag.slot].live = False
                self.gen.release(tag.slot)

    def _report(self):
        """This rank's gathered block: one row per open tag."""
        np = self._np
        block = np.full((self.local_slots, _ROW_HEAD + self._cap), -1,
                        np.int32)
        for row, (tag_id, tag) in enumerate(list(self._tags.items())):
            take = tag.buf[:self._cap]
            del tag.buf[:self._cap]
            done = tag.finished and not tag.buf
            block[row, :_ROW_HEAD] = (tag_id, tag.slot, int(done), len(take))
            block[row, _ROW_HEAD:_ROW_HEAD + len(take)] = take
            if done:
                del self._tags[tag_id]
        return block

    def _gather(self) -> list | None:
        """One fixed-shape gather to rank 0: the blocks of every rank on
        rank 0, None elsewhere."""
        torch = self._torch
        t0 = time.perf_counter()
        block = torch.from_numpy(self._report())
        out = ([torch.empty_like(block) for _ in range(self.num_processes)]
               if self.process_id == 0 else None)
        self._dist.gather(block, out, dst=0, group=self._pg)
        self.stats["gather_s"] += time.perf_counter() - t0
        self.stats["gathers"] += 1
        return None if out is None else [b.numpy() for b in out]

    def _replay(self, cmd) -> list | None:
        """Apply one broadcast command on this rank; ADMIT and STEP end in
        the gather (its blocks on rank 0)."""
        op = int(cmd[0])
        if op == _OP_ADMIT:
            self.stats["admits"] += 1
            self._apply_admit(cmd)
            return self._gather()
        if op == _OP_STEP:
            self.stats["steps"] += 1
            self._apply_step()
            return self._gather()
        if op == _OP_CANCEL:
            self.stats["cancels"] += 1
            self._apply_cancel(cmd)
        return None

    # -- main loops ------------------------------------------------------------
    def run(self) -> None:
        self.setup()
        self.serve()

    def serve(self) -> None:
        try:
            if self.process_id == 0:
                self._run_rank0()
            else:
                self._run_follower()
        finally:
            self._teardown()

    def _run_follower(self) -> None:
        """Replay rank 0's command stream on the local Generator."""
        while True:
            cmd = self._broadcast(self._zero_cmd())
            if int(cmd[0]) == _OP_STOP:
                return
            self._replay(cmd)

    def _run_rank0(self) -> None:
        server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        server.bind(("0.0.0.0", self.port))
        server.listen(8)
        self.port = server.getsockname()[1]
        self._inbox: _queue.Queue = _queue.Queue()
        self._conns: set[_Conn] = set()
        self._active: dict[int, list] = {}
        self._pending: list[tuple] = []
        accept = threading.Thread(target=self._accept_loop, args=(server,),
                                  daemon=True, name="gofr-mh-accept")
        accept.start()
        # the launcher scrapes this line to find the model port
        print(f"MODEL_PORT {self.port}", flush=True)
        try:
            self._drive()
        except Exception as exc:
            # fail fast: answer every stream first (the typed error frame,
            # delivered before the sockets close), then a STOP broadcast,
            # the one command that can still pair with followers' next wait
            server.close()
            self._fail_all(_ERR_CONN_LOST, str(exc))
            try:
                self._broadcast(self._zero_cmd())  # op 0 == STOP
            except Exception:
                pass
            raise
        finally:
            server.close()
            for conn in list(self._conns):  # EOF every client reader
                conn.close()
                try:
                    conn.sock.close()
                except OSError:
                    pass

    def _fail_all(self, err: str, why: str = "") -> None:
        for conn, rid, span, *_ in self._active.values():
            conn.send({"id": rid, "error": err})
            self._end_span(span, why or err)
        for conn, rid, *_ in self._pending:
            conn.send({"id": rid, "error": err})
        self._active.clear()
        self._pending.clear()
        for c in list(self._conns):
            c.flush()

    def _accept_loop(self, server: socket.socket) -> None:
        while True:
            try:
                sock, _ = server.accept()
            except OSError:
                return  # server closed: drive loop exited
            conn = _Conn(sock)
            self._conns.add(conn)
            threading.Thread(target=self._read_loop, args=(conn,),
                             daemon=True, name="gofr-mh-conn").start()

    def _read_loop(self, conn: _Conn) -> None:
        """Per-connection reader: validate frames, queue work items for the
        drive loop (the one thread that calls a collective)."""
        stopping = False
        try:
            while True:
                req = recv_frame(conn.sock)
                if req is None:
                    break
                if not isinstance(req, dict):
                    conn.send({"error": "frame must be an object"})
                    continue
                op = req.get("op")
                if op == "stop":
                    # the connection stays alive for the {"stopped": true}
                    stopping = True
                    self._inbox.put(("stop", conn, None))
                    return
                if op == "cancel":
                    self._inbox.put(("cancel", conn, req.get("id")))
                    continue
                rid = req.get("id")
                try:
                    tokens = [int(t) for t in req.get("tokens", [])]
                    # clamp to the int32 command frame
                    max_new = max(1, min(int(req.get("max_new", 16)),
                                         1_000_000_000))
                except (TypeError, ValueError):
                    conn.send({"id": rid, "error": "tokens/max_new must be ints"})
                    continue
                if not tokens or len(tokens) > self.bucket_cap:
                    conn.send({"id": rid, "error":
                               f"prompt must be 1..{self.bucket_cap} tokens"})
                    continue
                vocab = self.cfg.vocab_size
                if any(t < 0 or t >= vocab for t in tokens):
                    conn.send({"id": rid, "error":
                               f"token ids must be 0..{vocab - 1}"})
                    continue
                tp = req.get("traceparent")
                self._inbox.put(("gen", conn,
                                 (rid, tokens, max_new,
                                  tp if isinstance(tp, str) else None)))
        except Exception:
            # one bad connection never takes rank 0 down, but loudly
            import traceback

            if self._logger is not None:
                self._logger.errorf("model-port connection failed: %s",
                                    traceback.format_exc())
            else:
                traceback.print_exc()
        finally:
            if not stopping:
                conn.close()
                self._conns.discard(conn)
                self._inbox.put(("bye", conn, None))

    @staticmethod
    def _end_span(span, status: str | None = None) -> None:
        if span is None:
            return
        if status is not None:
            span.set_status("ERROR", status)
        span.end()

    def _settle(self, blocks) -> None:
        """Rank 0: stream each gathered burst and finish the done rows
        (JAX's ``finish_dead``)."""
        L = self.local_slots
        for rank, block in enumerate(blocks):
            for row in block:
                tag = int(row[0])
                entry = self._active.get(tag)
                if tag < 0 or entry is None:
                    continue  # an empty row, or a cancelled request
                conn, rid, span, _, _ = entry
                entry[4] = rank * L + int(row[1])
                n = int(row[3])
                if n:
                    conn.send({"id": rid,
                               "tokens": row[_ROW_HEAD:_ROW_HEAD + n].tolist()})
                if row[2]:
                    conn.send({"id": rid, "done": True})
                    self._end_span(span)
                    del self._active[tag]

    def _place(self, wave) -> list:
        """Rank 0 places each admitted row on the rank with the most free
        slots (lowest rank on a tie)."""
        held = [0] * self.num_processes
        for entry in self._active.values():
            held[entry[3]] += 1
        placed = []
        for item in wave:
            rank = min(range(self.num_processes), key=lambda r: held[r])
            held[rank] += 1
            placed.append((rank, item))
        return placed

    def _free(self) -> int:
        return self.batch_slots - len(self._active)

    def _drive(self) -> None:
        """The lock-step scheduler: pop work, broadcast one command, apply
        it locally, gather, stream. Every device-touching command goes
        broadcast-first, so followers replay the identical sequence."""
        tags = itertools.count(1)
        active = self._active  # tag -> [conn, rid, span, rank, gslot]
        while True:
            cancels: list[int] = []
            busy = bool(self._pending) or bool(active)
            idled = False
            items = []
            try:
                if busy:  # never block while decode work is runnable
                    items.append(self._inbox.get_nowait())
                else:
                    items.append(self._inbox.get(timeout=self.heartbeat_s))
            except _queue.Empty:
                idled = not busy
            while True:
                try:
                    items.append(self._inbox.get_nowait())
                except _queue.Empty:
                    break
            for kind, conn, payload in items:
                if kind == "stop":
                    self._broadcast(self._zero_cmd())  # STOP
                    self._fail_all(_ERR_STOPPED)
                    conn.send({"stopped": True})
                    for c in list(self._conns):  # final frames first
                        c.flush()
                    return
                if kind == "gen":
                    rid, tokens, max_new, tp = payload
                    self._pending.append((conn, rid, tokens, max_new, tp))
                elif kind == "cancel":
                    self._pending = [p for p in self._pending
                                     if not (p[0] is conn and p[1] == payload)]
                    cancels.extend(t for t, e in active.items()
                                   if e[0] is conn and e[1] == payload)
                elif kind == "bye":
                    self._pending = [p for p in self._pending
                                     if p[0] is not conn]
                    cancels.extend(t for t, e in active.items()
                                   if e[0] is conn)
            # drop requests whose connection died since queueing
            self._pending = [p for p in self._pending if p[0].alive]
            cancels.extend(t for t, e in active.items() if not e[0].alive)

            # -- one broadcast + local apply per iteration ----------------
            if cancels:
                cancels = sorted(set(cancels))
                cmd = self._encode_cancel([(active[t][4], t)
                                           for t in cancels])
                self._broadcast(cmd)
                self._replay(cmd)
                for t in cancels:
                    self._end_span(active.pop(t)[2], "cancelled")
                continue
            free = self._free()
            if self._pending and free:
                wave = self._pending[:free]
                self._pending = self._pending[free:]
                placed = []
                for rank, (conn, rid, toks, max_new, tp) in self._place(wave):
                    tag = next(tags) & 0x7FFF_FFFF
                    span = None
                    if self._tracer is not None:
                        # the mesh half of the request, in the same trace
                        # the front end opened
                        span = self._tracer.start_span(
                            "ml.mesh.generate", parent=parse_traceparent(tp),
                            kind="SERVER", activate=False,
                            attributes={"ml.rank": rank})
                    active[tag] = [conn, rid, span, rank, -1]
                    placed.append((rank, tag, toks, max_new))
                cmd = self._encode_admit(placed)
                self._broadcast(cmd)
                self._settle(self._replay(cmd))
            elif active:
                cmd = self._zero_cmd(_OP_STEP)
                self._broadcast(cmd)
                self._settle(self._replay(cmd))
            elif idled:
                # heartbeat: followers re-enter broadcast inside the
                # collective timeout; clients get the same liveness signal
                self._broadcast(self._zero_cmd(_OP_NOOP))
                for c in list(self._conns):
                    c.send({"noop": True})


class MultiHostLLMClient:
    """Front-end side: asyncio client for rank 0's model port,
    multiplexed — many concurrent ``stream()`` / ``generate()`` calls
    share one connection, each tagged with a request id; a single reader
    task dispatches frames to per-request queues."""

    def __init__(self, host: str, port: int, *,
                 heartbeat_gap_s: float = 15.0) -> None:
        # liveness deadline for a connection with streams in flight: the
        # worker heartbeats idle conns every ``heartbeat_s`` and every
        # burst counts, so a longer silence means rank 0 is dead without a
        # FIN (a kill -9'd host, a black-holed route)
        if heartbeat_gap_s <= 0:
            raise ValueError(
                f"heartbeat_gap_s must be positive, got {heartbeat_gap_s}")
        self.heartbeat_gap_s = float(heartbeat_gap_s)
        self.host, self.port = host, port
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._reader_task: asyncio.Task | None = None
        self._conn_lock = asyncio.Lock()
        self._send_lock = asyncio.Lock()
        self._ids = itertools.count(1)
        self._streams: dict[int, asyncio.Queue] = {}
        self._stop_waiter: asyncio.Future | None = None
        self._closed = False

    async def _ensure(self) -> None:
        async with self._conn_lock:
            if self._closed:
                # under the lock (close() takes it too): the retry path
                # never resurrects a closed client
                raise ServerClosed("model client closed")
            # a live connection needs a writable transport AND a live
            # dispatcher: after the worker dies the reader exits on EOF
            # while the writer still looks open
            if (self._writer is not None and not self._writer.is_closing()
                    and self._reader_task is not None
                    and not self._reader_task.done()):
                return
            if self._writer is not None:
                self._writer.close()
            # retire the old reader before the new connection takes
            # registrations: fail every stream bound to the dead one here
            if self._reader_task is not None and not self._reader_task.done():
                self._reader_task.cancel()
            self._reader_task = None
            for q in list(self._streams.values()):
                q.put_nowait({"error": _ERR_CONN_LOST})
            if self._stop_waiter and not self._stop_waiter.done():
                self._stop_waiter.set_result(False)
            self._reader, self._writer = await asyncio.open_connection(
                self.host, self.port)
            self._reader_task = asyncio.create_task(self._read_frames())

    async def _send(self, obj: Any) -> None:
        raw = json.dumps(obj).encode()
        async with self._send_lock:
            self._writer.write(struct.pack(">I", len(raw)) + raw)
            await self._writer.drain()

    async def _read_frames(self) -> None:
        """Single dispatcher: route each frame to its request's queue.
        Every read is bounded by ``heartbeat_gap_s``: a gap past it with
        streams in flight declares the connection lost; an idle
        connection just re-arms the wait."""
        gap = self.heartbeat_gap_s
        try:
            while True:
                try:
                    header = await asyncio.wait_for(
                        self._reader.readexactly(4), timeout=gap)
                except asyncio.TimeoutError:
                    if not self._streams:
                        continue
                    break
                (size,) = struct.unpack(">I", header)
                # a torn frame is fatal even when idle
                frame = json.loads(await asyncio.wait_for(
                    self._reader.readexactly(size), timeout=gap))
                if not isinstance(frame, dict):
                    continue
                if frame.get("stopped"):
                    if self._stop_waiter and not self._stop_waiter.done():
                        self._stop_waiter.set_result(True)
                    continue
                q = self._streams.get(frame.get("id"))
                if q is not None:
                    q.put_nowait(frame)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            # wake every in-flight consumer, but only if this reader is
            # still the current one (a superseded reader's streams were
            # failed over by _ensure)
            if self._reader_task is asyncio.current_task():
                for q in list(self._streams.values()):
                    q.put_nowait({"error": _ERR_CONN_LOST})
                if self._stop_waiter and not self._stop_waiter.done():
                    self._stop_waiter.set_result(False)

    async def stream_chunks(self, prompt_ids: Iterable[int],
                            max_new: int) -> AsyncIterator[list[int]]:
        """Yield bursts of generated tokens. A lost model connection
        raises ``GeneratorCrashed`` (503), a stopped mesh ``ServerClosed``
        (503); a request that has not yet yielded gets one transparent
        reconnect-and-resend first."""
        prompt = list(prompt_ids)
        traceparent = current_traceparent()
        retried = False
        while True:
            try:
                await self._ensure()
            except OSError as exc:
                raise GeneratorCrashed(
                    f"model worker connection failed "
                    f"({self.host}:{self.port}: {exc})") from exc
            rid = next(self._ids)
            q: asyncio.Queue = asyncio.Queue()
            self._streams[rid] = q
            finished = False
            yielded = False
            retrying = False
            try:
                try:
                    frame = {"op": "generate", "id": rid,
                             "tokens": prompt, "max_new": max_new}
                    if traceparent is not None:
                        frame["traceparent"] = traceparent
                    await self._send(frame)
                except (ConnectionError, OSError) as exc:
                    finished = True  # never reached the mesh: no cancel
                    if not retried:
                        retrying = True
                    else:
                        raise GeneratorCrashed(
                            f"model connection lost ({exc})") from exc
                while not retrying:
                    frame = await q.get()
                    if "error" in frame:
                        finished = True
                        err = str(frame["error"])
                        if err == _ERR_CONN_LOST:
                            if not yielded and not retried:
                                retrying = True
                                break
                            raise GeneratorCrashed(
                                _ERR_CONN_LOST +
                                (" mid-stream" if yielded else ""))
                        if err == _ERR_STOPPED:
                            raise ServerClosed("model workers stopped")
                        # validation rejects stay client errors
                        raise ValueError(err)
                    if frame.get("done"):
                        finished = True
                        return
                    yielded = True
                    yield [int(t) for t in frame.get("tokens", [])]
            finally:
                self._streams.pop(rid, None)
                if not finished and not retrying:
                    # abandoned mid-stream: free the mesh slot
                    try:
                        await self._send({"op": "cancel", "id": rid})
                    except Exception:
                        await self.close()
                elif retrying:
                    # the loss notice may have been stale (a peer's
                    # reconnect raced our send): cancel best-effort before
                    # resending; unknown rids are a no-op on the worker
                    try:
                        await self._send({"op": "cancel", "id": rid})
                    except Exception:
                        pass
            retried = True

    async def stream(self, prompt_ids: Iterable[int],
                     max_new: int) -> AsyncIterator[int]:
        """Token-at-a-time view of ``stream_chunks``."""
        agen = self.stream_chunks(prompt_ids, max_new)
        try:
            async for burst in agen:
                for tok in burst:
                    yield tok
        finally:
            await agen.aclose()

    async def generate(self, prompt_ids: Iterable[int],
                       max_new: int) -> list[int]:
        out: list[int] = []
        async for burst in self.stream_chunks(prompt_ids, max_new):
            out.extend(burst)
        return out

    async def shutdown_workers(self) -> None:
        """Stop the whole mesh (all ranks exit)."""
        await self._ensure()
        self._stop_waiter = asyncio.get_running_loop().create_future()
        await self._send({"op": "stop"})
        await self._stop_waiter

    async def close(self) -> None:
        async with self._conn_lock:  # serialize against an in-flight _ensure
            self._closed = True
            if self._writer is not None:
                self._writer.close()
                self._writer = None
            if self._reader_task is not None:
                self._reader_task.cancel()
                self._reader_task = None
        # the cancelled reader is superseded: fail in-flight consumers here
        # with the STOPPED sentinel (typed ServerClosed, no reconnect)
        for q in list(self._streams.values()):
            q.put_nowait({"error": _ERR_STOPPED})
        if self._stop_waiter and not self._stop_waiter.done():
            self._stop_waiter.set_result(False)

    async def health_check(self) -> dict:
        up = {"status": "UP",
              "details": {"model_addr": f"{self.host}:{self.port}",
                          "in_flight": len(self._streams)}}
        if self._writer is not None and not self._writer.is_closing():
            return up
        try:
            await self._ensure()
            return up
        except (OSError, ServerClosed) as exc:
            return {"status": "DOWN",
                    "details": {"model_addr": f"{self.host}:{self.port}",
                                "error": str(exc)[:200]}}
