"""TCP streaming server: live PCM in, per-frame scores out, over StreamPool
(counterpart of ``sed_tpu.serve_socket``).

It puts the lifecycle pool (stream_pool.py: device rings, sparse batched
ticks, exact join/leave) behind a socket so any client that can write PCM
gets real-time scores:

  * connect            = StreamPool.join (a free slot, else the connection
                         is refused with an error frame)
  * write audio frames = StreamPool.feed — ANY piece sizes, each client at
                         its own rate; a timer thread ticks the pool, so all
                         clients with a full chunk share ONE batched device
                         dispatch
  * end-of-stream      = StreamPool.leave — the partial remainder drains
                         through the exact host flush; the tail scores come
                         back before the final empty frame

Scores returned over a connection's lifetime equal offline inference on the
concatenated audio (the streaming invariant; pinned by
tests/test_torch_serve_socket.py against the offline scorer).

Wire protocol (little-endian, symmetric framing):
  client -> server   [u32 n_bytes][n_bytes of audio]       audio piece
                     [u32 0]                               end of stream
  server -> client   [u32 n_bytes][n_bytes of float32]     (frames*classes)
                     scores, frame-major; classes is fixed by the model
                     [u32 0]                               stream complete
  On join failure (pool full) the server sends [u32 0xFFFFFFFF] and closes.

Audio encoding is a server-level ``wire`` mode (both sides must agree):
'pcm16' (default) = int16 PCM; 'mulaw' = 1-byte/sample µ-law companded
audio (ops/mulaw.py), half the network bytes per client at the codec's
~38 dB SQNR (a lossy serving tier).  µ-law bytes go to the pool as uint8 and
are decoded on the device in the tick's ingest.

Threading: per-connection reader threads only stage audio (host numpy)
through the pool's thread-safe feed() (no server lock), so clients keep
staging while a tick's device work runs.  Device work (ticks, batched
drains) is serialized under the server lock.
"""

from __future__ import annotations

import socket
import struct
import sys
import threading
from typing import Dict, Optional

import numpy as np

_U32 = struct.Struct("<I")
ERR_FULL = 0xFFFFFFFF


def _send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_U32.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            return None
        buf += part
    return buf


def _recv_frame(sock: socket.socket,
                max_bytes: Optional[int] = None) -> Optional[bytes]:
    """Returns payload bytes, b'' for an end marker, None on EOF/error.
    Raises RuntimeError on the ERR_FULL join-refusal header and ValueError
    on a length prefix beyond ``max_bytes`` (a garbage/abusive header — the
    u32 wire length is unsigned, so "negative" lengths land here too)."""
    head = _recv_exact(sock, 4)
    if head is None:
        return None
    n = _U32.unpack(head)[0]
    if n == ERR_FULL:
        raise RuntimeError("server pool is full")
    if max_bytes is not None and n > max_bytes:
        raise ValueError(f"frame length {n} exceeds the {max_bytes}-byte cap")
    if n == 0:
        return b""
    return _recv_exact(sock, n)


class StreamServer:
    """Serve a StreamPool over TCP.

    ``pool``: a configured :class:`sed_tpu_torch.stream_pool.StreamPool`.
    ``tick_interval``: seconds between batched device ticks (clamped to
    >= 1 ms — the tick loop is timer-driven, not staged-gated).
    ``wire``: client audio encoding — 'pcm16' int16 (default) or 'mulaw'
    1-byte µ-law (see module docstring).
    ``max_frame_bytes``: reject any client frame whose length prefix exceeds
    this (default 64 MiB ≈ 11 min of 48 kHz PCM16 in ONE frame — far above
    any sane piece size).  A public length-prefixed reader must bound what a
    garbage or hostile header can make it buffer; an oversized prefix closes
    only that connection (its slot drains and frees, like any reader error).
    """

    def __init__(self, pool, host: str = "127.0.0.1", port: int = 0,
                 tick_interval: float = 0.05, wire: str = "pcm16",
                 max_frame_bytes: int = 64 << 20,
                 idle_timeout: Optional[float] = None,
                 drain_gather: float = 0.25, drain_timeout: float = 120.0):
        if wire not in ("pcm16", "mulaw"):
            raise ValueError(f"wire must be pcm16|mulaw, got {wire!r}")
        self.pool = pool
        self.wire = wire
        self.max_frame_bytes = int(max_frame_bytes)
        # How long a finishing stream waits for other finishers before its
        # drain flushes: concurrent stream ends coalesce into one batched
        # pool.leave_many (shared featurize + stacked forward).
        self.drain_gather = max(float(drain_gather), 1e-3)
        # The most a reader waits for its drain before it gives up, frees
        # the slot itself and closes the connection (fault R3, _reader).
        self.drain_timeout = float(drain_timeout)
        # Optional per-connection socket timeout: a client that stalls
        # mid-frame (slow loris) holds its slot only this long — the recv
        # timeout surfaces as an OSError on the reader, which drains and
        # frees the slot.  None (default) keeps the trusted-client behavior
        # of waiting indefinitely.
        self.idle_timeout = idle_timeout
        self.tick_interval = max(float(tick_interval), 1e-3)
        self._lock = threading.Lock()          # guards pool host state
        self._conns: Dict[int, socket.socket] = {}   # slot -> client socket
        self._drainq: Dict[int, dict] = {}     # slot -> pending drain request
        self._done = threading.Event()
        self._srv = socket.create_server((host, port))
        self.address = self._srv.getsockname()
        self._threads = []

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)
        t = threading.Thread(target=self._tick_loop, daemon=True)
        t.start()
        self._threads.append(t)

    def stop(self) -> None:
        self._done.set()
        # Shut the listener down before closing it (a divergence from
        # sed_tpu): on Linux close() alone does not wake the accept() blocked
        # in the accept thread, and the join below would wait out its 5 s.
        for end in (lambda: self._srv.shutdown(socket.SHUT_RDWR), self._srv.close):
            try:
                end()
            except OSError:
                pass
        # Close live client sockets FIRST so reader threads blocked in recv
        # wake up (their drain path then runs), and only then join.
        with self._lock:
            conns = list(self._conns.values())
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout=5)
        with self._lock:
            for sock in self._conns.values():
                try:
                    sock.close()
                except OSError:
                    pass
            self._conns.clear()

    # -- server internals ----------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._done.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return  # listener closed by stop()
            with self._lock:
                try:
                    slot = self.pool.join()
                except RuntimeError:
                    slot = None
            if slot is None:
                try:
                    conn.sendall(_U32.pack(ERR_FULL))
                    conn.close()
                except OSError:
                    pass
                continue
            if self.idle_timeout is not None:
                conn.settimeout(self.idle_timeout)
            t = threading.Thread(target=self._reader, args=(slot, conn),
                                 daemon=True)
            with self._lock:
                self._conns[slot] = conn
                # Prune finished readers so the list doesn't scale with
                # total historical connections.
                self._threads = [x for x in self._threads if x.is_alive()]
                self._threads.append(t)
            t.start()

    def _reader(self, slot: int, conn: socket.socket) -> None:
        """Stage this client's audio; on end-of-stream, disconnect, or ANY
        error, drain the slot (never leak it) and reply with the final
        frames when the end was orderly."""
        payload = None
        try:
            while True:
                payload = _recv_frame(conn, max_bytes=self.max_frame_bytes)
                if payload:  # audio piece
                    if self.wire == "mulaw":
                        # Raw µ-law bytes go straight to the pool (the
                        # uint8 ingest convention): 1 byte/sample to the
                        # device, decoded in the tick (ops/mulaw.py).
                        pcm = np.frombuffer(payload, dtype=np.uint8)
                    else:
                        if len(payload) % 2:
                            payload = None  # malformed int16 frame: drop
                            break
                        pcm = np.frombuffer(payload, dtype="<i2")
                    # StreamPool.feed is thread-safe: no server lock, so
                    # readers keep staging while a tick's device work runs.
                    self.pool.feed(slot, pcm)
                    continue
                break  # b'' = explicit end; None = client vanished
        except (OSError, RuntimeError, ValueError):
            payload = None  # reset/garbage frame: drain without replying
        finally:
            # Queue the drain rather than draining inline: streams leaving
            # together coalesce into one batched pool.leave_many.  The first
            # reader into the lock after its gather window drains the whole
            # queue; tick scores keep flowing to a queued slot's socket in
            # the meantime (see _tick_once_locked), so no frames are lost.
            req = {"conn": conn, "orderly": payload is not None,
                   "event": threading.Event()}
            with self._lock:
                self._conns.pop(slot, None)
                self._drainq[slot] = req
            self._done.wait(self.drain_gather)  # gather window (no lock)
            with self._lock:
                if not req["event"].is_set():
                    self._flush_drains_locked()
            # Set by whoever drained the queue; the timeout is a last-ditch
            # safeguard so a reader thread can never hang forever.
            if not req["event"].wait(timeout=self.drain_timeout):
                self._abandon_drain(slot, req)
            try:
                conn.close()
            except OSError:
                pass

    def _abandon_drain(self, slot: int, req: dict) -> None:
        """The drain of ``slot`` did not finish within ``drain_timeout``.

        Divergence from ``sed_tpu`` (fault R3): there the slot's drain-queue
        entry stayed behind and the slot leaked until some later drain
        claimed it.  Here the entry is removed under the lock and the slot is
        left, its tail dropped (the connection is closing)."""
        with self._lock:
            if self._drainq.get(slot) is not req:
                return  # drained after all, between the wait and the lock
            del self._drainq[slot]
            try:
                self.pool.leave_many([slot])
            except Exception as e:  # noqa: BLE001 - keep serving the rest
                print(f"serve_socket: abandoned drain of slot {slot} failed: "
                      f"{e!r}", file=sys.stderr, flush=True)
        print(f"serve_socket: drain of slot {slot} timed out after "
              f"{self.drain_timeout} s; slot freed, tail dropped",
              file=sys.stderr, flush=True)

    def _flush_drains_locked(self) -> None:
        """Drain every queued leave in one batched call (lock held).  Tails
        are sent under the SAME lock as the tick sends, so frames on one
        socket never interleave across threads.

        A tick runs first, while the drain queue is still intact: a client
        faster than real time can stage a deep backlog and then signal
        end-of-stream, and the ring tick scores that backlog from raw chunks
        where leave_many's host flush would upload every frame as f32.  The
        tick's scores route to the leaving clients through their drain-queue
        entries, so the queue must not be swapped out before it runs
        (tests/test_torch_serve_socket.py::
        test_flooding_client_receives_every_frame pins the full count).  New
        drains cannot enqueue mid-call: the lock is held."""
        if not self._drainq:
            return
        self._tick_guarded_locked()
        q, self._drainq = self._drainq, {}
        try:
            tails = self.pool.leave_many(list(q))
        except Exception as e:  # noqa: BLE001 - device fault during a shared
            # drain.  The pool freed the slots before scoring, so nothing
            # leaks; drop these tails, close the connections (the clients
            # see a connection error, not silence), and keep serving the
            # other slots.
            print(f"serve_socket: batched drain failed for slots "
                  f"{sorted(q)}: {e!r}", file=sys.stderr, flush=True)
            tails = {}
        for slot, req in q.items():
            # try/finally: the event MUST be set no matter what escapes the
            # per-slot send — a queued reader whose drainq entry was already
            # swapped out would otherwise block forever on event.wait().
            try:
                tail = tails.get(slot)
                if isinstance(tail, Exception):
                    # Per-slot host-side failure (a ring/schedule invariant
                    # violation would land here): say so loudly, drop the
                    # tail.
                    print(f"serve_socket: drain failed for slot {slot}: "
                          f"{tail!r}", file=sys.stderr, flush=True)
                    tail = None
                if req["orderly"] and tail is not None:
                    try:
                        if tail.shape[0]:
                            _send_frame(req["conn"], np.ascontiguousarray(
                                tail, dtype="<f4").tobytes())
                        req["conn"].sendall(_U32.pack(0))
                    except OSError:
                        pass
            finally:
                req["event"].set()

    def _tick_guarded_locked(self) -> None:
        """:meth:`_tick_once_locked`, with a tick fault reported and served
        past: the pool keeps the scores a failed tick had computed and the
        next tick delivers them (fault R2, StreamPool.tick)."""
        try:
            self._tick_once_locked()
        except Exception as e:  # noqa: BLE001 - keep serving
            print(f"serve_socket: tick failed: {e!r}", file=sys.stderr, flush=True)

    def _tick_once_locked(self) -> None:
        """One pool tick + score delivery (lock held).  Shared by the timer
        loop and the drain flush (which ticks to consume a leaver's staged
        backlog through the ring path before the exact tail flush)."""
        out = self.pool.tick()
        for slot, scores in out.items():
            sock = self._conns.get(slot)
            if sock is None:
                # A slot queued for drain still ticks until the
                # batched drain claims it; its frames belong to the
                # (orderly) leaving client, not the floor.
                req = self._drainq.get(slot)
                if req is not None and req["orderly"]:
                    sock = req["conn"]
            if sock is None or not scores.shape[0]:
                continue
            try:
                _send_frame(sock, np.ascontiguousarray(
                    scores, dtype="<f4").tobytes())
            except OSError:
                pass  # client vanished; its reader handles the leave

    def _tick_loop(self) -> None:
        # Sends stay under the lock: score frames for one socket must never
        # interleave with the reader's tail send.  A client that stops
        # reading can therefore stall the tick clock — acceptable for the
        # trusted-client serving this targets; put per-slot writer queues in
        # front if exposed to untrusted consumers.
        while not self._done.wait(self.tick_interval):
            with self._lock:
                self._tick_guarded_locked()


class StreamClient:
    """Minimal blocking client for :class:`StreamServer`'s wire protocol.

    ``wire`` must match the server's mode: 'pcm16' sends int16 samples;
    'mulaw' companded 1-byte µ-law (``send`` encodes int16/float input)."""

    def __init__(self, host: str, port: int, classes_num: int = 1,
                 wire: str = "pcm16"):
        if wire not in ("pcm16", "mulaw"):
            raise ValueError(f"wire must be pcm16|mulaw, got {wire!r}")
        self.classes = int(classes_num)
        self.wire = wire
        self._sock = socket.create_connection((host, port))

    def send(self, pcm: np.ndarray) -> None:
        """Send audio samples (any length): int16 PCM, or — in 'mulaw'
        wire mode — int16/float input companded to 1 byte/sample here."""
        if self.wire == "mulaw":
            from sed_tpu_torch.ops.mulaw import mulaw_encode

            payload = mulaw_encode(np.asarray(pcm)).tobytes()
        else:
            payload = np.ascontiguousarray(
                np.asarray(pcm), dtype="<i2").tobytes()
        _send_frame(self._sock, payload)

    def poll(self) -> Optional[np.ndarray]:
        """Blocking read of one score frame -> (frames, classes), or None
        when the server signals stream completion."""
        payload = _recv_frame(self._sock)  # raises RuntimeError on ERR_FULL
        if payload is None:
            raise ConnectionError("server closed the connection")
        if payload == b"":
            return None
        arr = np.frombuffer(payload, dtype="<f4")
        return arr.reshape(-1, self.classes)

    def finish(self) -> np.ndarray:
        """Signal end of stream and collect every remaining score frame."""
        self._sock.sendall(_U32.pack(0))
        outs = []
        while True:
            sc = self.poll()
            if sc is None:
                break
            outs.append(sc)
        self._sock.close()
        return (np.concatenate(outs, axis=0) if outs
                else np.zeros((0, self.classes), np.float32))
