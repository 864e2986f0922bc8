"""Process-side serving host for the wire transport: a copy of
``paddle_tpu/inference/procserve.py`` (it imports no jax) whose child
process runs the port's engine on the CUDA card.

:mod:`transport` defines the frames and the client
(:class:`~paddle_tpu_torch.inference.transport.RemoteReplica`); this
module is everything on the OTHER side of the boundary:

- :class:`EngineHost` — one ``ServingEngine`` behind a
  ``handle(frame_bytes) -> reply_bytes`` dispatcher.  The SAME class
  serves both transports: :class:`~paddle_tpu_torch.inference.transport.
  LoopbackTransport` calls ``handle`` in-process, the child's accept
  loop calls it per socket frame.  The host owns the per-request server
  state the protocol needs — a token cursor per tracked request
  (``stepped`` replies carry ``tokens[cursor:]`` deltas, the
  ``TokenStream`` flush contract applied to the wire) and a
  shipped-parcel map (a request entering ``swapped`` ships its
  host-tier parcel bytes exactly once per preemption, so the client
  proxy can stage a local copy for post-mortem migration).  Shipping a
  parcel is where a lazy handoff parcel's rows materialize.
- :class:`TCPStoreLite` — a minimal TCPStore-style rendezvous
  registry (``set``/``get``/``wait`` over one TCP socket), just
  enough for children to publish ``replica/<label>/<gen> ->
  host:port`` and parents to resolve it.
- :class:`EngineProcess` — the supervisor: spawn a child that runs
  ``paddle_tpu_torch.inference.procserve.main``, wait for its
  rendezvous registration, kill it, restart it as generation N+1 (a
  respawned child re-registers under a NEW store key, so a stale
  address can never be re-resolved).  ``dryrun=True`` records the exact
  command without launching, so a test can assert the launch surface
  without paying a process.
- ``tiny_llama_engine`` — an importable engine factory children can
  build from (the port's seeded 1-layer tiny Llama, on ``device``: the
  CUDA card unless the kwargs say ``"cpu"``; a child that cannot see
  CUDA raises instead of serving on the CPU), with a deterministic
  in-child fault schedule (``exit_at_step`` puts a real ``os._exit`` on
  a chosen scheduler step — a REAL process death at a deterministic
  point, no parent-side kill races).

Determinism note: the host never reads the wall clock on behalf of
the engine — ``step`` frames carry the router's ``now`` and the reply
carries host truth back, so a socket replica schedules exactly like a
local one given the same frame sequence.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from .serving import (AdmissionError, EngineStalledError,
                      PoisonedDispatchError, ReplicaKilledError)
from .transport import (_HEADER, _PLANE, WIRE_VERSION, decode_frame,
                        encode_frame, err_to_wire, rows_from_planes,
                        sampling_from_wire, wire_planes)

_ENGINE_ERRORS = (AdmissionError, ReplicaKilledError,
                  PoisonedDispatchError, EngineStalledError,
                  ValueError)


class EngineHost:
    """One engine behind the frame protocol.

    ``fault_spec`` arms a deterministic in-process schedule keyed on
    the UPCOMING scheduler step (consulted before each ``step`` frame
    dispatches): ``{"force_swap_rid", "force_swap_step"}`` preempts a
    request (optionally parking it via ``"park_allocs": true``, which
    fails every later allocation so the parcel stays staged), and
    ``"exit_at_step"`` arms ``FaultInjector.exit_at_step`` — the host
    consumes it with ``take_exit`` and dies with ``os._exit``: a real
    process death at a deterministic scheduler step."""

    def __init__(self, engine, *, label: str = "replica",
                 fault_spec: Optional[dict] = None):
        self._e = engine
        self.label = str(label)
        self._fault_spec = dict(fault_spec or {})
        self._seq_in = 0
        self._seq_out = 0
        # rid -> (Request, token cursor); rid -> shipped host_key
        self._track: Dict[int, list] = {}
        self._shipped: Dict[int, int] = {}
        if self._fault_spec:
            inj = getattr(engine, "_fault", None)
            if inj is None:
                raise ValueError(
                    "fault_spec needs an engine built with a "
                    "FaultInjector (fault_injector=...)")
            if self._fault_spec.get("exit_at_step") is not None:
                inj.exit_at_step(
                    int(self._fault_spec["exit_at_step"]))

    def reset_wire(self):
        """New connection, fresh per-direction sequence space (the
        client resets its counters on reconnect; engine and request
        tracking persist — the connection is transport state, the
        engine is replica state)."""
        self._seq_in = 0
        self._seq_out = 0

    def _reply(self, kind: str, payload=None, planes=()):
        buf = encode_frame(kind, self._seq_out, payload, planes)
        self._seq_out += 1
        return buf

    # -- request bookkeeping --
    def _adopt(self, req, cursor: Optional[int] = None):
        self._track[req.request_id] = [
            req, len(req.tokens) if cursor is None else int(cursor)]

    def _update_of(self, rid: int) -> dict:
        req, cur = self._track[rid]
        u = {"rid": rid, "state": req.state,
             "tok": [int(x) for x in req.tokens[cur:]],
             "ne": int(req.n_emitted),
             "ftt": req.first_token_time,
             "fin": req.finish_time,
             "pf": int(getattr(req, "pf_pos", 0))}
        self._track[rid][1] = len(req.tokens)
        return u

    def _parcel_diff(self):
        """Newly-swapped parcels to ship (bytes ride as reply planes)
        and previously-shipped rids whose staging is now stale."""
        parcels, planes, unstaged = [], [], []
        for rid, (req, _cur) in self._track.items():
            swap = getattr(req, "swap", None)
            if req.state == "swapped" and swap is not None:
                if self._shipped.get(rid) == swap.host_key:
                    continue           # this preemption already shipped
                ent = self._e._host_tier.entry(swap.host_key)
                if ent is None:
                    continue
                rows = [np.ascontiguousarray(r) for r in ent.rows]
                parcels.append({"rid": rid, "n_planes": len(rows),
                                "n_blocks": int(swap.n_blocks),
                                "tok": int(swap.tok),
                                "lens": int(swap.lens),
                                "phase": str(swap.state),
                                "pf_pos": int(getattr(req, "pf_pos",
                                                      0))})
                planes.extend(wire_planes(rows, ent.dtypes))
                self._shipped[rid] = swap.host_key
            elif rid in self._shipped:
                del self._shipped[rid]
                unstaged.append(rid)
        return parcels, planes, unstaged

    # -- frame dispatch --
    def handle(self, buf: bytes) -> bytes:
        kind, seq, obj, planes, _n = decode_frame(buf)
        if seq != self._seq_in:
            return self._reply("error", {
                "name": "TransportError",
                "msg": f"request sequence gap: got {seq}, expected "
                       f"{self._seq_in}"})
        self._seq_in += 1
        try:
            return self._dispatch(kind, obj, planes)
        except _ENGINE_ERRORS as e:
            return self._reply("error", err_to_wire(e))

    def _dispatch(self, kind: str, obj, planes) -> bytes:
        e = self._e
        if kind == "hello":
            if (obj or {}).get("version") != WIRE_VERSION:
                return self._reply("error", {
                    "name": "TransportError",
                    "msg": f"client protocol version "
                           f"{(obj or {}).get('version')} != "
                           f"{WIRE_VERSION}"})
            reg = e.metrics_registry
            rkey = getattr(reg, "dedupe_key", None) or f"id{id(reg)}"
            spec = e.engine_spec()
            spec["version"] = WIRE_VERSION
            spec["label"] = self.label
            # pid-qualified: stable across re-serialization, distinct
            # across processes even when two children were built from
            # one factory
            spec["registry_key"] = f"{os.getpid()}:{rkey}"
            return self._reply("welcome", spec)
        if kind == "submit":
            req = e.submit(
                np.asarray(obj["ids"], np.int32),
                seq_len=obj.get("seq_len"),
                max_new_tokens=obj["max_new_tokens"],
                arrival_time=obj.get("arrival_time"),
                spec_decode=obj.get("spec_decode"),
                sampling=sampling_from_wire(obj.get("sampling")),
                priority=obj.get("priority", 0),
                deadline_s=obj.get("deadline_s"),
                max_queue_delay_s=obj.get("max_queue_delay_s"),
                adapter=obj.get("adapter"),
                tenant=obj.get("tenant"))
            self._adopt(req)
            sb = req.samp_base
            return self._reply("admitted", {
                "rid": req.request_id, "state": req.state,
                "seq_len": int(req.seq_len),
                "arrival_time": float(req.arrival_time),
                "samp_base": (None if sb is None else
                              [int(x) for x in
                               np.asarray(sb, np.uint32)])})
        if kind == "cancel":
            rid = int(obj["rid"])
            ok = e.cancel(rid)
            updates = ([self._update_of(rid)]
                       if rid in self._track else [])
            unstaged = []
            if rid in self._shipped:
                del self._shipped[rid]
                unstaged.append(rid)
            self._track.pop(rid, None)
            return self._reply("ack", {"ok": ok, "updates": updates,
                                       "unstaged": unstaged})
        if kind == "step":
            self._arm_step_faults()
            terminal = e.step(now=obj.get("now"))
            handoffs = [r for r in getattr(e, "take_handoffs",
                                           lambda: [])()]
            updates = [self._update_of(rid)
                       for rid in sorted(self._track)]
            # the handoff parcels ship through the SAME diff as
            # preemption swaps (tracked + "swapped" + tier entry);
            # the reply's "handoffs" rid list is what tells the proxy
            # they are chunk-final handoffs awaiting router pickup
            parcels, pplanes, unstaged = self._parcel_diff()
            hand_ids = []
            for r in handoffs:
                hand_ids.append(int(r.request_id))
                # once shipped, the client's staged planes are the
                # authoritative bytes — drop the server copy and stop
                # tracking (the router rebinds the request to its
                # decode replica via migrate_in, a fresh rid there)
                e._host_tier.drop(r.swap.host_key)
                self._track.pop(r.request_id, None)
                self._shipped.pop(r.request_id, None)
            if handoffs:
                e._update_host_gauge()
            term_ids = [int(r.request_id) for r in terminal]
            for rid in term_ids:
                self._track.pop(rid, None)
                self._shipped.pop(rid, None)
            return self._reply("stepped", {
                "updates": updates, "parcels": parcels,
                "unstaged": unstaged, "terminal": term_ids,
                "handoffs": hand_ids,
                "step_idx": int(e._step_idx)}, tuple(pplanes))
        if kind == "load_report":
            return self._reply("load", e.load_report())
        if kind == "prefix_match":
            return self._reply("matched", {
                "matched": int(e.prefix_match(
                    np.asarray(obj["ids"], np.int32)))})
        if kind == "migrate_in":
            meta = obj.get("parcel")
            parcel = None
            if meta is not None:
                rows, dtypes = rows_from_planes(
                    planes[:int(meta["n_planes"])])
                key = e._host_tier.put(rows, int(meta["n_blocks"]),
                                       "preempt", dtypes)
                parcel = {"key": key,
                          "n_blocks": int(meta["n_blocks"]),
                          "tok": int(meta["tok"]),
                          "lens": int(meta["lens"]),
                          "phase": str(meta["phase"]),
                          "pf_pos": int(meta["pf_pos"])}
            sb = obj.get("samp_base")
            req = e.migrate_in(
                np.asarray(obj["ids"], np.int32),
                seq_len=obj["seq_len"],
                max_new_tokens=obj["max_new_tokens"],
                arrival_time=obj.get("arrival_time"),
                spec_decode=obj.get("spec_decode"),
                sampling=sampling_from_wire(obj.get("sampling")),
                priority=obj.get("priority", 0),
                deadline_s=obj.get("deadline_s"),
                max_queue_delay_s=obj.get("max_queue_delay_s"),
                adapter=obj.get("adapter"),
                tenant=obj.get("tenant"),
                samp_base=(None if sb is None
                           else np.asarray(sb, np.uint32)),
                tokens=tuple(obj.get("tokens", ())),
                first_token_time=obj.get("first_token_time"),
                parcel=parcel)
            self._adopt(req)
            if parcel is not None:
                # the parcel arrived staged: mark it shipped so the
                # step diff does not re-ship bytes the client already
                # holds (its local copy became the new staging)
                swap = getattr(req, "swap", None)
                if swap is not None:
                    self._shipped[req.request_id] = swap.host_key
            return self._reply("admitted", {
                "rid": req.request_id, "state": req.state,
                "seq_len": int(req.seq_len),
                "arrival_time": float(req.arrival_time),
                "samp_base": None})
        if kind == "crash_reset":
            stripped = e.crash_reset()
            self._track.clear()
            self._shipped.clear()
            return self._reply("reset", {
                phase: [int(r.request_id) for r in reqs]
                for phase, reqs in stripped.items()})
        if kind == "metrics":
            return self._reply("stats", e.metrics_registry.snapshot())
        if kind == "record":
            fr = e.flight_recorder
            return self._reply("events", {"record": {
                "version": 1, "capacity": fr.capacity,
                "dropped": fr.dropped,
                "n_events": len(fr.events()),
                "events": [ev.as_dict() for ev in fr.events()]}})
        if kind == "probe":
            return self._reply("ack", {
                "ok": True, "label": self.label,
                "step_idx": int(e._step_idx)})
        return self._reply("error", {
            "name": "TransportError",
            "msg": f"frame kind {kind!r} is not a request"})

    def _arm_step_faults(self):
        """Translate the declarative ``fault_spec`` into injector
        arms at the step they are scheduled for, and consume a
        pending process exit (``os._exit`` — no teardown, no atexit:
        the point is an ABRUPT death the parent only sees as a dead
        socket)."""
        spec = self._fault_spec
        if not spec:
            return
        inj = self._e._fault
        upcoming = self._e._step_idx + 1
        if spec.get("force_swap_step") == upcoming:
            inj.force_swap(int(spec["force_swap_rid"]))
            if spec.get("park_allocs"):
                inj.fail_allocs(None)
        if inj.take_exit(upcoming):
            os._exit(17)


# ---------------------------------------------------------------------------
# rendezvous: a minimal TCPStore
# ---------------------------------------------------------------------------

class TCPStoreLite:
    """A wait-capable string KV over one TCP socket — the rendezvous
    primitive: children ``set`` their listen address, parents
    ``wait`` for it.  One request per connection (``SET k v`` /
    ``GET k`` / newline-framed, latin-1 values), server thread is a
    daemon in the parent."""

    @staticmethod
    def serve(host: str = "127.0.0.1", port: int = 0):
        """Start the store server; returns ``(addr, closer)``."""
        data: Dict[str, str] = {}
        cond = threading.Condition()
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(64)
        addr = srv.getsockname()
        stop = threading.Event()

        def _one(conn):
            try:
                f = conn.makefile("rw", encoding="latin-1",
                                  newline="\n")
                line = f.readline().strip()
                if line.startswith("SET "):
                    _cmd, k, v = line.split(" ", 2)
                    with cond:
                        data[k] = v
                        cond.notify_all()
                    f.write("OK\n")
                elif line.startswith("GET "):
                    k = line.split(" ", 1)[1]
                    with cond:
                        v = data.get(k)
                    f.write("NONE\n" if v is None else f"VAL {v}\n")
                else:
                    f.write("ERR\n")
                f.flush()
            except OSError:
                pass
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

        def _loop():
            while not stop.is_set():
                try:
                    conn, _peer = srv.accept()
                except OSError:
                    return
                threading.Thread(target=_one, args=(conn,),
                                 daemon=True).start()

        t = threading.Thread(target=_loop, daemon=True)
        t.start()

        def _close():
            stop.set()
            try:
                srv.close()
            except OSError:
                pass

        return addr, _close

    def __init__(self, addr):
        self._addr = (str(addr[0]), int(addr[1]))

    def _ask(self, line: str) -> str:
        with socket.create_connection(self._addr, timeout=10.0) as s:
            f = s.makefile("rw", encoding="latin-1", newline="\n")
            f.write(line + "\n")
            f.flush()
            return f.readline().strip()

    def set(self, key: str, value: str):
        if self._ask(f"SET {key} {value}") != "OK":
            raise RuntimeError(f"store refused SET {key}")

    def get(self, key: str) -> Optional[str]:
        r = self._ask(f"GET {key}")
        return r[4:] if r.startswith("VAL ") else None

    def wait(self, key: str, timeout_s: float = 60.0) -> str:
        deadline = time.monotonic() + float(timeout_s)
        while time.monotonic() < deadline:
            v = self.get(key)
            if v is not None:
                return v
            time.sleep(0.05)
        raise TimeoutError(
            f"store key {key!r} not published within {timeout_s}s")


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------

class EngineProcess:
    """Spawn / kill / restart one serving child.

    The child runs ``paddle_tpu_torch.inference.procserve.main`` with
    an importable engine ``factory`` (``"module:function"``) and a
    JSON kwargs blob, publishes ``replica/<label>/<gen> ->
    host:port`` in the store, then serves frames.  A restart bumps
    the GENERATION, so the parent's address resolution can never land
    on a stale registration — the transport's ``respawn`` path.

    ``dryrun=True`` records the launch command without spawning: a test
    asserts the supervisor's launch/restart surface for free.  The
    child inherits the parent's environment plus ``env``."""

    def __init__(self, label: str, factory: str, kwargs: dict,
                 store_addr, *, dryrun: bool = False,
                 env: Optional[dict] = None):
        self.label = str(label)
        self.factory = str(factory)
        self.kwargs = dict(kwargs)
        self.store_addr = (str(store_addr[0]), int(store_addr[1]))
        self.dryrun = bool(dryrun)
        self.gen = 0
        self.commands: List[List[str]] = []   # every launch, in order
        self._proc: Optional[subprocess.Popen] = None
        self._env = dict(env or {})
        self.spawn()

    def _command(self) -> List[str]:
        kw = dict(self.kwargs)
        if self.gen > 0:
            # the fault schedule belonged to generation 0: a respawned
            # replica is a FRESH healthy process (the operator's
            # restart), so an armed exit_at_step must not re-kill
            # every generation and wedge the failover loop
            kw.pop("fault_spec", None)
        # -c instead of -m: the module is imported by the package
        # __init__, so ``runpy`` would warn about re-executing it
        return [sys.executable, "-c",
                "from paddle_tpu_torch.inference.procserve import main; "
                "main()",
                "--store", f"{self.store_addr[0]}:{self.store_addr[1]}",
                "--label", self.label, "--gen", str(self.gen),
                "--factory", self.factory,
                "--kwargs", json.dumps(kw, sort_keys=True)]

    def spawn(self):
        cmd = self._command()
        self.commands.append(cmd)
        if self.dryrun:
            return
        env = dict(os.environ)
        env.update(self._env)
        self._proc = subprocess.Popen(cmd, env=env)

    def alive(self) -> bool:
        return (self._proc is not None
                and self._proc.poll() is None)

    def address(self, timeout_s: float = 60.0):
        """Resolve THIS generation's listen address via the store
        (None in dryrun — there is no child to resolve)."""
        if self.dryrun:
            return None
        store = TCPStoreLite(self.store_addr)
        v = store.wait(f"replica/{self.label}/{self.gen}",
                       timeout_s=timeout_s)
        host, port = v.rsplit(":", 1)
        return (host, int(port))

    def kill(self):
        if self._proc is not None and self._proc.poll() is None:
            self._proc.kill()
        if self._proc is not None:
            try:
                self._proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
        self._proc = None

    def restart(self):
        """Kill (if needed) and respawn as the next generation."""
        self.kill()
        self.gen += 1
        self.spawn()

    def returncode(self) -> Optional[int]:
        return None if self._proc is None else self._proc.poll()


# ---------------------------------------------------------------------------
# the importable engine factory
# ---------------------------------------------------------------------------

def tiny_llama_engine(*, seed: int = 1234, num_slots: int = 2,
                      prompt_len: int = 32, max_cache_len: int = 48,
                      block_len: int = 4, num_blocks: int = 16,
                      chunk_len: int = 4, engine_seed: int = 0,
                      with_fault_injector: bool = False,
                      role: str = "both", device: str = "cuda"):
    """Deterministic tiny-llama ``ServingEngine`` — the importable
    factory ``EngineProcess`` children build from (and an in-process
    reference builds from, so socket-vs-reference token parity is a
    pure-transport comparison): the port's 1-layer Llama with weights
    from ``seed``, float32, on ``device`` (the CUDA card unless told
    ``"cpu"``; without CUDA the card raises)."""
    from ..models import LlamaConfig, LlamaForCausalLM
    from ..observability import MetricsRegistry
    from ..observability.flightrec import FlightRecorder
    from .faultinject import FaultInjector
    from .serving import ServingEngine

    cfg = LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=1, num_attention_heads=4,
        num_key_value_heads=2, max_position_embeddings=64)
    net = LlamaForCausalLM(cfg, device=device, seed=int(seed))
    net.eval()
    return ServingEngine(
        net, num_slots=int(num_slots), prompt_len=int(prompt_len),
        max_cache_len=int(max_cache_len), steps_per_call=1,
        block_len=int(block_len), chunk_len=int(chunk_len),
        num_blocks=int(num_blocks), compute_dtype="float32",
        seed=int(engine_seed), registry=MetricsRegistry(),
        flight_recorder=FlightRecorder(),
        fault_injector=FaultInjector() if with_fault_injector
        else None, role=str(role), device=device)


def _resolve_factory(spec: str):
    mod_name, fn_name = spec.split(":", 1)
    import importlib
    mod = importlib.import_module(mod_name)
    return getattr(mod, fn_name)


def serve_forever(engine, *, label: str, store: TCPStoreLite,
                  gen: int, fault_spec: Optional[dict] = None,
                  host: str = "127.0.0.1"):
    """The child's accept loop: bind an ephemeral port, publish it in
    the store under this generation, then serve one connection at a
    time (the router is single-threaded; reconnects are tolerated —
    each accepted connection resets the wire sequence space)."""
    eh = EngineHost(engine, label=label, fault_spec=fault_spec)
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, 0))
    srv.listen(4)
    a = srv.getsockname()
    store.set(f"replica/{label}/{gen}", f"{a[0]}:{a[1]}")
    while True:
        conn, _peer = srv.accept()
        eh.reset_wire()
        try:
            while True:
                head = _recv_exact(conn, _HEADER.size)
                if head is None:
                    break
                (_m, _v, _k, _f, _seq, plen, n_planes,
                 _pad) = _HEADER.unpack(head)
                body = head
                more = _recv_exact(conn, plen)
                if more is None:
                    break
                body += more
                truncated = False
                for _ in range(n_planes):
                    ph = _recv_exact(conn, _PLANE.size)
                    if ph is None:
                        truncated = True
                        break
                    dlen, ndim, nbytes = _PLANE.unpack(ph)
                    rest = _recv_exact(conn,
                                       dlen + 4 * ndim + nbytes)
                    if rest is None:
                        truncated = True
                        break
                    body += ph + rest
                if truncated:
                    break
                conn.sendall(eh.handle(body))
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass


def _recv_exact(conn, n: int) -> Optional[bytes]:
    if n == 0:
        return b""
    chunks, got = [], 0
    while got < n:
        try:
            c = conn.recv(min(1 << 20, n - got))
        except OSError:
            return None
        if not c:
            return None
        chunks.append(c)
        got += len(c)
    return b"".join(chunks)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="paddle_tpu_torch serving replica child")
    ap.add_argument("--store", required=True,
                    help="rendezvous store host:port")
    ap.add_argument("--label", required=True)
    ap.add_argument("--gen", type=int, default=0)
    ap.add_argument("--factory", required=True,
                    help="engine factory as module:function")
    ap.add_argument("--kwargs", default="{}",
                    help="JSON kwargs for the factory")
    args = ap.parse_args(argv)

    kw = json.loads(args.kwargs)
    fault_spec = kw.pop("fault_spec", None)
    if fault_spec:
        kw.setdefault("with_fault_injector", True)
    factory = _resolve_factory(args.factory)
    engine = factory(**kw)
    host, port = args.store.rsplit(":", 1)
    store = TCPStoreLite((host, int(port)))
    serve_forever(engine, label=args.label, store=store,
                  gen=args.gen, fault_spec=fault_spec)


if __name__ == "__main__":
    main()
