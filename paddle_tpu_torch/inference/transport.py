"""Wire transport for multi-process replica serving: a copy of
``paddle_tpu/inference/transport.py`` (it imports no jax) whose frames
are byte for byte the JAX package's, so a replica of either package can
sit behind a proxy of either.

The :class:`~paddle_tpu_torch.inference.router.Router` consumes a
narrow engine surface — ``submit`` / ``cancel`` / ``step`` /
``load_report`` / ``prefix_match`` / ``crash_reset`` / ``migrate_in``
— that was designed against host-side state only.  This module lifts
that surface across a process boundary without changing ONE router
line of scheduling logic: :class:`RemoteReplica` implements the same
surface over a framed protocol, and the router routes/fails-over/
migrates against it exactly as it does against an in-process
``ServingEngine``.

**The protocol** is a closed vocabulary of frame kinds
(``FRAME_KINDS``, like ``EVENT_KINDS``): a versioned fixed header
(magic, protocol version, kind, per-direction sequence number, payload /
plane sizes), one canonical-JSON payload, and zero or more raw
binary PLANES.  Planes are what make migration parcels
serialization-free: a preempt swap parcel is already exact at-rest
host bytes by construction (one contiguous ``[n_blocks, ...]`` numpy
stack per flat arena — int8 codes + f32 scale planes for the
quantized cache), so the wire form IS the at-rest form, dtype/shape
header plus ``tobytes()``.  Token streaming needs no new shape
either: ``TokenStream``'s cursor contract (``tokens`` is append-only,
flushes are ``tokens[pos:]`` deltas) is exactly a wire protocol, so
``stepped`` replies carry per-request token DELTAS against a
server-side cursor and the proxy's mirror list grows append-only.

**bfloat16 planes.**  A port parcel keeps a bf16 arena's rows as the
``uint16`` view of their bits, with the dtype name beside them
(``_HostEntry.dtypes``).  On the wire such a plane carries the dtype
string a JAX replica's ``ml_dtypes`` bfloat16 plane carries,
``"<V2"`` (:data:`BF16_WIRE`), over the same bytes, so the frame is the
JAX package's byte for byte; a received 2-byte void plane comes back as
``uint16`` bits named ``"bfloat16"`` (:func:`rows_from_planes`).  (The
JAX package itself cannot resume such a plane: its swap-in scatter
refuses the void dtype.)

**Two transports, one interface** (``rpc(kind, payload, planes)``):

- :class:`LoopbackTransport` runs the full encode -> dispatch ->
  encode -> decode path against an in-process
  :class:`~paddle_tpu_torch.inference.procserve.EngineHost` — every
  byte is framed and parsed, but no socket, no process, no wall.
  Because the protocol is synchronous and carries exactly the
  information the router already read, a router over loopback proxies
  schedules **byte-identically** to the bare router (admission order,
  dispatch counts, flight-recorder event stories) — the
  single-replica-identity contract applied at the transport layer.
- :class:`SocketTransport` speaks the same frames over blocking TCP
  to an :class:`~paddle_tpu_torch.inference.procserve.EngineProcess`
  child.  A dead peer (EOF, ECONNREFUSED, a mid-frame truncation)
  surfaces as :class:`TransportDeadError` — a ``ReplicaKilledError``
  subclass, so it is a member of the router's ``REPLICA_FAULT_ERRORS``
  by ``isinstance`` and a real child death drives the SAME failover
  machinery as an injected kill: requeue / staged-parcel migration /
  recompute, token-exact.

**Parcel staging** is what makes migration survive a dead process:
whenever a request enters ``swapped`` on the server, the reply ships
its parcel bytes and the proxy stages them in a LOCAL
:class:`~paddle_tpu_torch.inference.prefixcache.HostTier`.  The
router's failover reads ``req.swap.host_key`` off the (local) mirror
and ``HostTier.transfer``s from the proxy's tier — all host-side, all
still reachable after the child is gone.  The staged copy drops when
the request resumes or finishes.

Sequence numbers are deterministic (a per-direction counter starting
at 0, contiguity-checked at both ends), so two runs of one trace
produce identical frame sequences.
"""

from __future__ import annotations

import json
import socket
import struct
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..observability import metrics as obs_metrics
from .prefixcache import HostTier
from .sampling import SamplingParams
from .serving import (AdmissionError, EngineStalledError,
                      PoisonedDispatchError, ReplicaKilledError)

# -- the closed frame vocabulary (every entry has a literal rpc() or
# _reply() emit site; a typo'd kind fails encode_frame() at runtime) --
FRAME_KINDS = (
    # handshake
    "hello", "welcome",
    # request lifecycle (client -> server, server reply)
    "submit", "admitted",
    "cancel", "step", "stepped",
    # scheduler-signal snapshots
    "load_report", "load",
    "prefix_match", "matched",
    # failover surface
    "migrate_in", "crash_reset", "reset",
    # observability fetches
    "metrics", "stats",
    "record", "events",
    # transport-level health + generic ack / typed error relay
    "probe", "ack", "error",
)

WIRE_VERSION = 1
_MAGIC = b"PTWF"
# magic[4] version:u16 kind:u8 flags:u8 seq:u64 payload_len:u32
# n_planes:u16 pad:u16  -> 24 bytes
_HEADER = struct.Struct(">4sHBBQIHH")
# per-plane: dtype_len:u8 ndim:u8 nbytes:u64 then dtype ascii + dims u32
_PLANE = struct.Struct(">BBQ")
# the dtype string of a bfloat16 plane: what ml_dtypes' bfloat16 writes
# as ``dtype.str``, and so what a JAX replica's bf16 parcel carries
BF16_WIRE = "<V2"


class TransportError(RuntimeError):
    """Protocol-level failure that is NOT a dead peer: an unknown
    frame kind, a sequence-number gap, an unserializable submit
    (``mask_processor`` holds host callables), a handshake mismatch."""


class FrameVersionError(TransportError):
    """The frame's protocol version is not ``WIRE_VERSION`` — the
    peer speaks a different protocol revision; refusing loudly beats
    misparsing its payload."""


class FrameTruncatedError(TransportError):
    """The buffer ends before the header (or the header's promised
    payload/planes) — a partial read, never a parse guess."""


class FrameCorruptError(TransportError):
    """The bytes are not a frame at all: bad magic, an out-of-range
    kind index, a plane header that contradicts its sizes."""


class TransportDeadError(ReplicaKilledError):
    """The peer process is gone (EOF / refused / reset mid-frame).

    Subclassing ``ReplicaKilledError`` makes a real child death a
    member of the router's ``REPLICA_FAULT_ERRORS`` by ``isinstance``
    — ``_classify_fault`` reads it as ``"kill"`` and the
    failover paths (requeue / staged-parcel migration / recompute)
    recover the replica's requests token-exact, exactly as for an
    injected kill."""


def _canon_payload(obj) -> bytes:
    """Canonical JSON bytes: sorted keys, no whitespace — two encodes
    of one payload are byte-identical (frame-sequence determinism)."""
    if obj is None:
        return b""
    return json.dumps(obj, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


class WirePlane:
    """A plane whose bytes are ``array``'s but whose wire dtype string
    is ``dtype_str`` (a bfloat16 stack held as ``uint16`` bits goes out
    as :data:`BF16_WIRE`)."""

    __slots__ = ("array", "dtype_str")

    def __init__(self, array: np.ndarray, dtype_str: str):
        self.array = array
        self.dtype_str = str(dtype_str)


def wire_planes(rows, dtypes=None) -> Tuple:
    """A host-tier parcel's row stacks as frame planes: each stack
    whose bits decode to bfloat16 (``dtypes``, one torch dtype name per
    stack) as a :class:`WirePlane` in the JAX package's bf16 form, every
    other stack as itself."""
    dts = dtypes if dtypes is not None else [None] * len(rows)
    return tuple(WirePlane(r, BF16_WIRE) if dt == "bfloat16" else r
                 for r, dt in zip(rows, dts))


def rows_from_planes(planes) -> Tuple[List[np.ndarray], Tuple[str, ...]]:
    """Received parcel planes as host-tier rows and the dtype name each
    stack's bits decode to: a 2-byte void plane (bfloat16 on the wire)
    becomes its ``uint16`` bits named ``"bfloat16"``, any other plane
    an owned copy named by its numpy dtype."""
    rows, dtypes = [], []
    for a in planes:
        a = np.array(a)
        if a.dtype.kind == "V" and a.dtype.itemsize == 2:
            rows.append(a.view(np.uint16))
            dtypes.append("bfloat16")
        else:
            rows.append(a)
            dtypes.append(a.dtype.name)
    return rows, tuple(dtypes)


def encode_frame(kind: str, seq: int, payload=None,
                 planes: Tuple = ()) -> bytes:
    """One wire frame: header + canonical-JSON payload + raw binary
    planes.  ``planes`` carry EXACT array bytes (dtype string with
    endianness, dims, then ``tobytes()``) — the serialization-free
    parcel path; a :class:`WirePlane` names its own dtype string."""
    if kind not in FRAME_KINDS:
        raise TransportError(
            f"unknown frame kind {kind!r} — known: {FRAME_KINDS}")
    body = _canon_payload(payload)
    parts = [b"", body]
    for arr in planes:
        dstr = None
        if isinstance(arr, WirePlane):
            arr, dstr = arr.array, arr.dtype_str
        a = np.ascontiguousarray(arr)
        dt = (dstr if dstr is not None else a.dtype.str).encode("ascii")
        parts.append(_PLANE.pack(len(dt), a.ndim, a.nbytes))
        parts.append(dt)
        parts.append(struct.pack(f">{a.ndim}I", *a.shape))
        parts.append(a.tobytes())
    parts[0] = _HEADER.pack(_MAGIC, WIRE_VERSION,
                            FRAME_KINDS.index(kind), 0, int(seq),
                            len(body), len(planes), 0)
    return b"".join(parts)


def decode_frame(buf: bytes):
    """Parse one frame: ``(kind, seq, payload, planes, total_len)``.
    Raises the typed errors (:class:`FrameTruncatedError` /
    :class:`FrameCorruptError` / :class:`FrameVersionError`) instead
    of guessing — a truncated socket read retries, a corrupt frame is
    a dead or alien peer."""
    if len(buf) < _HEADER.size:
        raise FrameTruncatedError(
            f"frame header needs {_HEADER.size} bytes, got {len(buf)}")
    magic, ver, kidx, _flags, seq, plen, n_planes, _pad = \
        _HEADER.unpack_from(buf, 0)
    if magic != _MAGIC:
        raise FrameCorruptError(
            f"bad frame magic {magic!r} (expected {_MAGIC!r})")
    if ver != WIRE_VERSION:
        raise FrameVersionError(
            f"frame protocol version {ver} != {WIRE_VERSION} — "
            f"mismatched peers")
    if kidx >= len(FRAME_KINDS):
        raise FrameCorruptError(
            f"frame kind index {kidx} out of range "
            f"({len(FRAME_KINDS)} kinds)")
    off = _HEADER.size
    if len(buf) < off + plen:
        raise FrameTruncatedError(
            f"payload needs {plen} bytes at offset {off}, frame has "
            f"{len(buf) - off}")
    payload = (json.loads(buf[off:off + plen].decode("utf-8"))
               if plen else None)
    off += plen
    planes: List[np.ndarray] = []
    for _ in range(n_planes):
        if len(buf) < off + _PLANE.size:
            raise FrameTruncatedError("plane header truncated")
        dlen, ndim, nbytes = _PLANE.unpack_from(buf, off)
        off += _PLANE.size
        need = dlen + 4 * ndim
        if len(buf) < off + need:
            raise FrameTruncatedError("plane dtype/shape truncated")
        dt = buf[off:off + dlen].decode("ascii")
        off += dlen
        shape = struct.unpack(f">{ndim}I", buf[off:off + 4 * ndim])
        off += 4 * ndim
        if len(buf) < off + nbytes:
            raise FrameTruncatedError(
                f"plane body needs {nbytes} bytes, frame has "
                f"{len(buf) - off}")
        arr = np.frombuffer(buf[off:off + nbytes],
                            dtype=np.dtype(dt))
        try:
            arr = arr.reshape(shape)
        except ValueError as e:
            raise FrameCorruptError(
                f"plane shape {shape} does not fit {nbytes} bytes of "
                f"{dt}: {e}") from None
        planes.append(arr)
        off += nbytes
    return FRAME_KINDS[kidx], seq, payload, planes, off


# -- typed-error relay: the server catches the engine's typed errors
# and ships (name, message, kwargs); the client re-raises the SAME
# type so the router's except clauses fire unchanged across the wire
_WIRE_ERRORS = {
    "AdmissionError": AdmissionError,
    "ReplicaKilledError": ReplicaKilledError,
    "PoisonedDispatchError": PoisonedDispatchError,
    "EngineStalledError": EngineStalledError,
    "ValueError": ValueError,
}


def err_to_wire(e: BaseException) -> dict:
    d = {"name": type(e).__name__, "msg": str(e)}
    if isinstance(e, AdmissionError):
        d["queue_depth"] = getattr(e, "queue_depth", None)
        d["max_queue"] = getattr(e, "max_queue", None)
    return d


def raise_from_wire(obj: dict):
    cls = _WIRE_ERRORS.get(obj.get("name", ""))
    if cls is AdmissionError:
        raise AdmissionError(obj.get("msg", ""),
                             queue_depth=obj.get("queue_depth"),
                             max_queue=obj.get("max_queue"))
    if cls is not None:
        raise cls(obj.get("msg", ""))
    raise TransportError(
        f"remote error {obj.get('name', '?')}: {obj.get('msg', '')}")


def sampling_to_wire(sp: Optional[SamplingParams]) -> Optional[dict]:
    """``SamplingParams`` as a JSON dict.  ``mask_processor`` holds a
    host-side callable/table pair that is NOT wire-shaped — refusing
    at the front door beats a pickle surprise in a child."""
    if sp is None:
        return None
    if sp.mask_processor is not None:
        raise TransportError(
            "sampling.mask_processor is not wire-serializable — "
            "constrained decoding runs against in-process replicas "
            "only")
    return {"temperature": sp.temperature, "top_k": sp.top_k,
            "top_p": sp.top_p,
            "repetition_penalty": sp.repetition_penalty,
            "seed": sp.seed}


def sampling_from_wire(d: Optional[dict]) -> Optional[SamplingParams]:
    if d is None:
        return None
    return SamplingParams(
        temperature=d["temperature"], top_k=d["top_k"],
        top_p=d["top_p"], repetition_penalty=d["repetition_penalty"],
        seed=d["seed"])


class _TransportInstruments:
    """The ``serving.transport.*`` registry handles (kind, help text
    and label tuple are the JAX package's, so merged snapshots
    compare equal)."""

    def __init__(self, registry):
        self.registry = registry
        r = registry
        self.frames = r.counter(
            "serving.transport.frames",
            "wire frames moved through a replica transport, by frame "
            "kind (requests at send, replies at receive) — the frame-"
            "sequence determinism surface the multiproc bench arm "
            "gates on", labels=("kind",))
        self.bytes_out = r.counter(
            "serving.transport.bytes_out",
            "encoded frame bytes sent to replica engine hosts "
            "(header + canonical-JSON payload + raw parcel planes)")
        self.bytes_in = r.counter(
            "serving.transport.bytes_in",
            "encoded frame bytes received from replica engine hosts")
        self.rpc_seconds = r.histogram(
            "serving.transport.rpc_seconds",
            "round-trip wall seconds per transport rpc (encode -> "
            "dispatch -> reply decode) — report-only wall, never a "
            "gate")


class LoopbackTransport:
    """In-process transport: frames are encoded, handed to an
    :class:`~paddle_tpu_torch.inference.procserve.EngineHost` (or any
    object with ``handle(frame_bytes) -> reply_bytes``), and the reply
    bytes decoded — the full protocol with no socket: byte-identical
    scheduling to the bare router, every codec path exercised."""

    kind = "loopback"

    def __init__(self, host, *, registry=None):
        self._host = host
        self._m = _TransportInstruments(
            registry if registry is not None
            else obs_metrics.get_registry())
        self._seq_out = 0
        self._seq_in = 0
        self.frames_by_kind: Dict[str, int] = {}
        self.bytes_out = 0
        self.bytes_in = 0

    def _count(self, kind: str):
        self.frames_by_kind[kind] = self.frames_by_kind.get(kind, 0) + 1
        self._m.frames.inc(kind=kind)

    def _exchange(self, buf: bytes) -> bytes:
        return self._host.handle(buf)

    def rpc(self, kind: str, payload=None, planes: Tuple = ()):
        """One synchronous request/reply exchange.  Returns
        ``(reply_kind, reply_payload, reply_planes)``; a relayed
        typed error re-raises as its original type."""
        t0 = time.perf_counter()
        buf = encode_frame(kind, self._seq_out, payload, planes)
        self._seq_out += 1
        self.bytes_out += len(buf)
        self._m.bytes_out.inc(len(buf))
        self._count(kind)
        rbuf = self._exchange(buf)
        rkind, rseq, robj, rplanes, _n = decode_frame(rbuf)
        if rseq != self._seq_in:
            raise TransportError(
                f"reply sequence gap: got {rseq}, expected "
                f"{self._seq_in}")
        self._seq_in += 1
        self.bytes_in += len(rbuf)
        self._m.bytes_in.inc(len(rbuf))
        self._count(rkind)
        self._m.rpc_seconds.observe(time.perf_counter() - t0)
        if rkind == "error":
            raise_from_wire(robj)
        return rkind, robj, rplanes

    def stats(self) -> dict:
        return {"kind": self.kind,
                "frames": dict(sorted(self.frames_by_kind.items())),
                "bytes_out": self.bytes_out,
                "bytes_in": self.bytes_in}

    def respawn(self):
        """Loopback has no process to restart — the in-process host
        survives; ``crash_reset`` rpcs handle the engine side."""

    def close(self):
        pass


class SocketTransport(LoopbackTransport):
    """The same protocol over blocking TCP to an
    :class:`~paddle_tpu_torch.inference.procserve.EngineProcess` child.

    Connection is lazy (first rpc connects; a respawned child's new
    address is re-resolved through the rendezvous store).  Any socket
    failure — refused, reset, EOF, a mid-frame truncation — marks the
    transport DEAD and raises :class:`TransportDeadError`; every
    further rpc fails fast until :meth:`respawn` restarts the child
    and clears the flag, so the router's step-indexed probe loop owns
    the retry schedule, not the socket layer."""

    kind = "socket"

    def __init__(self, process=None, *, address=None, registry=None,
                 connect_timeout_s: float = 60.0,
                 rpc_timeout_s: float = 600.0):
        super().__init__(host=None, registry=registry)
        if process is None and address is None:
            raise ValueError(
                "SocketTransport needs an EngineProcess or an "
                "(host, port) address")
        self._proc = process
        self._addr = address
        self._sock: Optional[socket.socket] = None
        self._dead = False
        self._connect_timeout_s = float(connect_timeout_s)
        self._rpc_timeout_s = float(rpc_timeout_s)

    # -- socket plumbing --
    def _die(self, why: str):
        self.close()
        self._dead = True
        raise TransportDeadError(
            f"replica transport died: {why} (respawn() restarts the "
            f"child and clears the fault)")

    def _connect(self):
        addr = self._addr
        if self._proc is not None:
            addr = self._proc.address(
                timeout_s=self._connect_timeout_s)
        if addr is None:
            self._die("no address for the replica child (rendezvous "
                      "timed out)")
        deadline = time.monotonic() + self._connect_timeout_s
        last = None
        while time.monotonic() < deadline:
            try:
                s = socket.create_connection(
                    tuple(addr), timeout=self._connect_timeout_s)
                s.settimeout(self._rpc_timeout_s)
                self._sock = s
                return
            except OSError as e:
                last = e
                if self._proc is not None and not self._proc.alive():
                    break
                time.sleep(0.05)
        self._die(f"cannot connect to {addr}: {last}")

    def _recv_exact(self, n: int) -> bytes:
        chunks = []
        got = 0
        while got < n:
            try:
                c = self._sock.recv(min(1 << 20, n - got))
            except OSError as e:
                self._die(f"recv failed: {e}")
            if not c:
                self._die("peer closed mid-frame (EOF)")
            chunks.append(c)
            got += len(c)
        return b"".join(chunks)

    def _exchange(self, buf: bytes) -> bytes:
        if self._dead:
            raise TransportDeadError(
                "replica transport is dead (respawn() restarts the "
                "child)")
        if self._sock is None:
            self._connect()
        try:
            self._sock.sendall(buf)
        except OSError as e:
            self._die(f"send failed: {e}")
        head = self._recv_exact(_HEADER.size)
        try:
            (_m, _v, _k, _f, _seq, plen, n_planes,
             _pad) = _HEADER.unpack(head)
        except struct.error as e:
            self._die(f"unparseable reply header: {e}")
        body = head
        # planes sizes are inside the stream: read payload, then each
        # plane header + body in turn
        body += self._recv_exact(plen)
        for _ in range(n_planes):
            ph = self._recv_exact(_PLANE.size)
            dlen, ndim, nbytes = _PLANE.unpack(ph)
            body += ph
            body += self._recv_exact(dlen + 4 * ndim + nbytes)
        return body

    def respawn(self):
        """Restart the dead child (next generation), reset the frame
        sequence space and clear the dead flag — the transport-level
        ``crash_reset``.  The reconnect itself stays lazy."""
        self.close()
        if self._proc is not None:
            self._proc.restart()
        self._dead = False
        self._seq_out = 0
        self._seq_in = 0

    def close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None


class _RemoteSwap:
    """Mirror of the server request's ``_SwapRecord``, with
    ``host_key`` re-pointed at the proxy's LOCAL staged parcel — the
    key the router's failover ``transfer``s from, reachable after
    the child dies."""

    __slots__ = ("host_key", "n_blocks", "tok", "lens", "state")

    def __init__(self, host_key, n_blocks, tok, lens, state):
        self.host_key = int(host_key)
        self.n_blocks = int(n_blocks)
        self.tok = int(tok)
        self.lens = int(lens)
        self.state = str(state)


class RemoteRequest:
    """Client-side mirror of one server request: the fields the
    router and its handles actually read (``state`` / append-only
    ``tokens`` / ``samp_base`` / swap record / timing), updated from
    ``stepped`` reply deltas.  Readable after the replica dies — the
    failover snapshot source."""

    def __init__(self, request_id: int, seq_len: int,
                 max_new_tokens: int, arrival_time: float,
                 pad_token_id: int):
        self.request_id = int(request_id)
        self.seq_len = int(seq_len)
        self.max_new_tokens = int(max_new_tokens)
        self.arrival_time = float(arrival_time)
        self.pad_token_id = int(pad_token_id)
        self.state = "queued"
        self.tokens: List[int] = []
        self.n_emitted = 0
        self.first_token_time: Optional[float] = None
        self.finish_time: Optional[float] = None
        self.samp_base: Optional[np.ndarray] = None
        self.pf_pos = 0
        self.preempt_count = 0
        self.swap: Optional[_RemoteSwap] = None

    @property
    def output(self) -> np.ndarray:
        return np.asarray(self.tokens, np.int32)

    @property
    def latency(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival_time

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time


class _SnapInstrument:
    """One instrument snapshot wearing the ``_snap()`` read surface
    the fleet monitor consumes."""

    def __init__(self, snap: dict):
        self._s = snap

    def _snap(self) -> dict:
        return self._s


class _RemoteRegistry:
    """Read-only registry shim over the replica's metrics rpc.
    ``dedupe_key`` is the SERVER registry's stable identity (pid-
    qualified), so two proxies over one shared registry — fresh shim
    objects, fresh snapshot dicts — still deduplicate in
    ``fleet_snapshot()`` and the SLO monitor."""

    def __init__(self, replica: "RemoteReplica", dedupe_key: str):
        self._r = replica
        self.dedupe_key = str(dedupe_key)

    def snapshot(self) -> dict:
        try:
            _k, obj, _p = self._r._t.rpc("metrics")
        except TransportDeadError:
            return {}
        return obj or {}

    def get(self, name: str):
        snap = self.snapshot().get(name)
        return None if snap is None else _SnapInstrument(snap)


class _RemoteAdapters:
    """The adapter-registration read surface the router validates
    against (``state(name) is None`` = unregistered), answered from
    the handshake's name set — no rpc per submit validation."""

    def __init__(self, names):
        self._names = set(names)

    def names(self):
        return sorted(self._names)

    def state(self, name: str):
        return {"name": name} if name in self._names else None


class _RemoteCfg:
    __slots__ = ("pad_token_id",)

    def __init__(self, pad_token_id: int):
        self.pad_token_id = int(pad_token_id)


class RemoteReplica:
    """The engine surface the router consumes, over a transport.

    The handshake (``hello`` -> ``welcome``) carries replica geometry
    (the homogeneity attrs the router validates), the pad token, the
    KV row stride (migration byte accounting), registered adapter
    names, the shard-group identity and the server registry's dedupe
    key.  After it, every router call maps to one rpc; ``step``
    replies carry per-request mirror deltas, terminal ids and any
    newly-staged swap parcels (raw planes, staged into the proxy's
    local :class:`HostTier` so failover migration survives the
    child's death)."""

    def __init__(self, transport):
        self._t = transport
        self.transport_kind = transport.kind
        _k, spec, _p = transport.rpc("hello",
                                     {"version": WIRE_VERSION})
        if spec.get("version") != WIRE_VERSION:
            raise TransportError(
                f"handshake version {spec.get('version')} != "
                f"{WIRE_VERSION}")
        self.label = spec.get("label", "replica")
        self.prompt_len = int(spec["prompt_len"])
        self.max_cache_len = int(spec["max_cache_len"])
        self.block_len = int(spec["block_len"])
        self.num_blocks = int(spec["num_blocks"])
        self.num_slots = int(spec["num_slots"])
        self.kv_cache_dtype = spec["kv_cache_dtype"]
        self.weight_dtype = spec["weight_dtype"]
        self._kv_row_bytes = int(spec["kv_row_bytes"])
        self.cfg = _RemoteCfg(spec["pad_token_id"])
        self.shard_group = spec.get("shard_group")
        # phase role rides the handshake: pre-role servers
        # never send it, and "both" keeps them routable everywhere
        self.role = str(spec.get("role", "both"))
        adapters = spec.get("adapters")
        self._adapters = (None if adapters is None
                          else _RemoteAdapters(adapters))
        # local staging tier: unbounded cache budget is irrelevant —
        # staged parcels ride reason "preempt", which always fits
        self._host_tier = HostTier()
        self._reqs: Dict[int, RemoteRequest] = {}
        self._staged: Dict[int, int] = {}      # rid -> local tier key
        self._handoff_ready: List[RemoteRequest] = []
        self._registry = _RemoteRegistry(self, spec["registry_key"])

    # -- geometry helpers the router calls client-side --
    def _blocks_needed(self, n: int, m: int) -> int:
        # the engine's ceil-div block geometry, replicated locally:
        # pure arithmetic over handshake attrs, no rpc per validation
        return -(-(n + m - 1) // self.block_len)

    # -- engine surface --
    def load_report(self) -> dict:
        _k, obj, _p = self._t.rpc("load_report")
        return obj

    def prefix_match(self, prompt_ids) -> int:
        ids = np.asarray(prompt_ids).reshape(-1).astype(np.int32)
        _k, obj, _p = self._t.rpc("prefix_match",
                                  {"ids": [int(x) for x in ids]})
        return int(obj["matched"])

    def submit(self, prompt_ids, seq_len=None, max_new_tokens=32,
               arrival_time=None, spec_decode=None,
               sampling: Optional[SamplingParams] = None,
               priority: int = 0, deadline_s: Optional[float] = None,
               max_queue_delay_s: Optional[float] = None,
               adapter: Optional[str] = None,
               tenant: Optional[str] = None) -> RemoteRequest:
        ids = np.asarray(prompt_ids).reshape(-1).astype(np.int32)
        _k, obj, _p = self._t.rpc("submit", {
            "ids": [int(x) for x in ids],
            "seq_len": None if seq_len is None else int(seq_len),
            "max_new_tokens": int(max_new_tokens),
            "arrival_time": (None if arrival_time is None
                             else float(arrival_time)),
            "spec_decode": (None if spec_decode is None
                            else int(spec_decode)),
            "sampling": sampling_to_wire(sampling),
            "priority": int(priority),
            "deadline_s": (None if deadline_s is None
                           else float(deadline_s)),
            "max_queue_delay_s": (None if max_queue_delay_s is None
                                  else float(max_queue_delay_s)),
            "adapter": adapter,
            "tenant": tenant,
        })
        req = RemoteRequest(obj["rid"], obj["seq_len"],
                            int(max_new_tokens),
                            obj["arrival_time"],
                            self.cfg.pad_token_id)
        if obj.get("samp_base") is not None:
            req.samp_base = np.asarray(obj["samp_base"], np.uint32)
        self._reqs[req.request_id] = req
        return req

    def cancel(self, request_id: int) -> bool:
        try:
            _k, obj, _p = self._t.rpc("cancel",
                                      {"rid": int(request_id)})
        except TransportDeadError:
            return False
        self._apply_updates(obj.get("updates", ()))
        self._drop_staged(obj.get("unstaged", ()))
        return bool(obj["ok"])

    def step(self, now: Optional[float] = None) -> List[RemoteRequest]:
        _k, obj, planes = self._t.rpc(
            "step", {"now": None if now is None else float(now)})
        self._apply_updates(obj.get("updates", ()))
        # stage newly-swapped parcels: planes arrive concatenated in
        # parcel order, each parcel consuming its declared plane count
        pi = 0
        for p in obj.get("parcels", ()):
            rows, dtypes = rows_from_planes(
                planes[pi:pi + int(p["n_planes"])])
            pi += int(p["n_planes"])
            rid = int(p["rid"])
            old = self._staged.pop(rid, None)
            if old is not None:
                self._host_tier.drop(old)
            key = self._host_tier.put(rows, int(p["n_blocks"]),
                                      "preempt", dtypes)
            self._staged[rid] = key
            req = self._reqs.get(rid)
            if req is not None:
                req.swap = _RemoteSwap(key, p["n_blocks"], p["tok"],
                                       p["lens"], p["phase"])
                req.pf_pos = int(p["pf_pos"])
                req.preempt_count += 1
        self._drop_staged(obj.get("unstaged", ()))
        # chunk-final handoffs: the reply names which of this
        # step's parcels are handoffs (vs pressure preemptions) — the
        # server already dropped ITS copy, the staged local planes
        # are now the authoritative bytes awaiting router pickup
        for rid in obj.get("handoffs", ()):
            req = self._reqs.get(int(rid))
            if req is not None:
                self._handoff_ready.append(req)
        out = []
        for rid in obj.get("terminal", ()):
            req = self._reqs.get(int(rid))
            if req is not None:
                out.append(req)
        return out

    def take_handoffs(self) -> List[RemoteRequest]:
        """Drain the chunk-final handoff mirrors staged by ``step``
        replies — the router ``transfer``s each parcel out of this
        proxy's tier, so the staged-key map entry goes with it."""
        out, self._handoff_ready = self._handoff_ready, []
        for req in out:
            self._staged.pop(req.request_id, None)
        return out

    def crash_reset(self) -> dict:
        """Reset the replica after a fault.  A still-reachable peer
        resets in place (the engine's ``crash_reset``); a dead socket
        peer respawns the child instead — same observable contract:
        the replica comes back empty and probe-able.  Respawn
        failures are swallowed (the transport stays dead and the next
        step-indexed probe retries), matching the bare router's
        keep-probing-a-dead-replica behavior."""
        stripped = {"queued": [], "active": [], "swapped": []}
        try:
            _k, obj, _p = self._t.rpc("crash_reset")
            stripped = obj
        except TransportDeadError:
            try:
                self._t.respawn()
            except Exception:
                pass
        self._reqs.clear()
        for key in list(self._staged.values()):
            self._host_tier.drop(key)
        self._staged.clear()
        self._handoff_ready = []
        return stripped

    def migrate_in(self, prompt_ids, *, seq_len, max_new_tokens,
                   arrival_time=None, spec_decode=None, sampling=None,
                   priority: int = 0, deadline_s=None,
                   max_queue_delay_s=None, adapter=None, tenant=None,
                   samp_base=None, tokens=(), first_token_time=None,
                   parcel: Optional[dict] = None) -> RemoteRequest:
        ids = np.asarray(prompt_ids).reshape(-1).astype(np.int32)
        planes: Tuple = ()
        meta = None
        if parcel is not None:
            ent = self._host_tier.entry(int(parcel["key"]))
            if ent is None:
                raise ValueError(
                    f"parcel key {parcel['key']!r} is not staged in "
                    f"this proxy's local tier")
            planes = wire_planes(ent.rows, ent.dtypes)
            meta = {"n_blocks": int(parcel["n_blocks"]),
                    "tok": int(parcel["tok"]),
                    "lens": int(parcel["lens"]),
                    "phase": str(parcel["phase"]),
                    "pf_pos": int(parcel["pf_pos"]),
                    "n_planes": len(planes)}
        _k, obj, _p = self._t.rpc("migrate_in", {
            "ids": [int(x) for x in ids],
            "seq_len": int(seq_len),
            "max_new_tokens": int(max_new_tokens),
            "arrival_time": (None if arrival_time is None
                             else float(arrival_time)),
            "spec_decode": (None if spec_decode is None
                            else int(spec_decode)),
            "sampling": sampling_to_wire(sampling),
            "priority": int(priority),
            "deadline_s": (None if deadline_s is None
                           else float(deadline_s)),
            "max_queue_delay_s": (None if max_queue_delay_s is None
                                  else float(max_queue_delay_s)),
            "adapter": adapter, "tenant": tenant,
            "samp_base": (None if samp_base is None
                          else [int(x) for x in
                                np.asarray(samp_base, np.uint32)]),
            "tokens": [int(x) for x in tokens],
            "first_token_time": (None if first_token_time is None
                                 else float(first_token_time)),
            "parcel": meta,
        }, planes)
        req = RemoteRequest(obj["rid"], int(seq_len),
                            int(max_new_tokens), obj["arrival_time"],
                            self.cfg.pad_token_id)
        req.state = obj["state"]
        req.tokens = [int(x) for x in tokens]
        req.first_token_time = first_token_time
        if samp_base is not None:
            req.samp_base = np.asarray(samp_base, np.uint32)
        self._reqs[req.request_id] = req
        if parcel is not None:
            # the local copy BECOMES the new staged parcel: the
            # destination holds the authoritative bytes now, but if
            # it also dies while the request waits swapped, migration
            # reads this stage — no re-ship, no re-serialization
            req.swap = _RemoteSwap(int(parcel["key"]),
                                   parcel["n_blocks"], parcel["tok"],
                                   parcel["lens"], parcel["phase"])
            req.pf_pos = int(parcel["pf_pos"])
            self._staged[req.request_id] = int(parcel["key"])
        return req

    # -- mirror bookkeeping --
    def _apply_updates(self, updates):
        for u in updates:
            req = self._reqs.get(int(u["rid"]))
            if req is None:
                continue
            req.state = u["state"]
            req.tokens.extend(int(x) for x in u.get("tok", ()))
            req.n_emitted = int(u.get("ne", req.n_emitted))
            if u.get("ftt") is not None:
                req.first_token_time = float(u["ftt"])
            if u.get("fin") is not None:
                req.finish_time = float(u["fin"])
            req.pf_pos = int(u.get("pf", req.pf_pos))

    def _drop_staged(self, rids):
        for rid in rids:
            key = self._staged.pop(int(rid), None)
            if key is not None:
                self._host_tier.drop(key)
            req = self._reqs.get(int(rid))
            if req is not None and req.state != "swapped":
                req.swap = None

    # -- observability surface --
    @property
    def metrics_registry(self):
        return self._registry

    @property
    def flight_recorder(self):
        """The replica's flight record as a pure-data dict (the
        ``stitch_flight_records`` loader accepts it directly); empty
        when the peer is dead — a lost ring, not a crash."""
        try:
            _k, obj, _p = self._t.rpc("record")
        except TransportDeadError:
            return {"events": [], "dropped": 0}
        return obj["record"]

    def transport_stats(self) -> dict:
        """Deterministic transport counters for ``fleet_snapshot()``
        (frame counts by kind, byte totals) plus the staged-parcel
        footprint."""
        st = self._t.stats()
        st["staged_parcels"] = len(self._staged)
        st["label"] = self.label
        return st

    def ping(self) -> bool:
        """Transport-level liveness probe (cheaper than the router's
        1-token generation probe; used by supervisors and tests)."""
        try:
            _k, obj, _p = self._t.rpc("probe")
            return bool(obj.get("ok"))
        except TransportDeadError:
            return False
