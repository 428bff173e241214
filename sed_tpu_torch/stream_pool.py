"""Device-resident streaming with a per-slot lifecycle (counterpart of
``sed_tpu.stream_pool``).

:class:`DeviceStreamingDetector` serves B lockstep streams.  Real serving
has churn, so this pool keeps the same device rings, a sample ring (B, L)
and a log-mel ring (B, M, mel), but gives every slot its own row of the tick
schedule (:func:`sed_tpu_torch.device_streaming.schedule_row`), so each
slot runs its own schedule phase:

  * :meth:`join` takes a free slot.  The stream's first chunks run through
    a host :class:`BatchedStreamingDetector` (the reflect-padding startup),
    then its state moves into the slot's ring rows; other slots never stop.
  * :meth:`leave` moves the slot's rows back to the host detector for the
    exact tail flush and frees the slot.
  * Slots without a chunk in a tick get an all-zero schedule row, an exact
    no-op: rows are independent in the tick (eval-mode BatchNorm), so junk in
    an idle row cannot reach an active one.

Chunks are fixed-size, one ``chunk_samples`` block per pushing stream, but
ticks are sparse: :meth:`push` takes any subset of the joined slots, and
:meth:`feed` / :meth:`tick` accept audio in pieces of any size.  Several
rounds of full chunks go to the device in one call (:meth:`_push_rounds`):
one upload of the real chunks and the schedule, a loop of ticks on the
device, one download of the scores.

A slot's scores equal a fresh single-stream detector on the same audio, with
identical emission boundaries (tests/test_torch_stream_pool.py).

With a ``mesh`` (``parallel.mesh``, one rank per device) the slot axis of
the rings is sharded: each rank keeps and ticks the rows of its slice of
the slots, and the scores of every tick are gathered, so every rank returns
what the one-process pool returns.  Everything on the host (the schedule,
the startup and the drains) runs identically on every rank, which must all
make the same calls with the same audio (the SPMD contract).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from sed_tpu_torch.configs import DEFAULT_SPECTROGRAM, SpectrogramConfig
from sed_tpu_torch.device_streaming import (SCHEDULE_SCALARS, RingTick,
                                            resolve_tick_featurizer, ring_geometry,
                                            schedule_row)
from sed_tpu_torch.inference import resolve_device
from sed_tpu_torch.ops.featurizer import ingest_to_f32_np, resolve_featurizer_precision
from sed_tpu_torch.parallel.mesh import gather_rows, local_rows, row_from_owner
from sed_tpu_torch.streaming import BatchedStreamingDetector, make_stream_fns, tick_schedule


def wire_dtype(chunks) -> np.dtype:
    """The narrowest dtype every chunk can ride the upload in: int16 (PCM16)
    or uint8 (µ-law) when all chunks share it, else float32 (host-decoded)."""
    dts = {np.asarray(c).dtype for c in chunks}
    uniform = dts.pop() if len(dts) == 1 else None
    if uniform in (np.dtype(np.int16), np.dtype(np.uint8)):
        return uniform
    return np.dtype(np.float32)


def flatten_pieces(pieces: List[np.ndarray]) -> np.ndarray:
    """Concatenate a slot's staged pieces; mixed dtypes promote through the
    host ingest rules (:func:`ingest_to_f32_np`)."""
    if len(pieces) == 1:
        return pieces[0]
    if len({p.dtype for p in pieces}) == 1:
        return np.concatenate(pieces)
    return np.concatenate([ingest_to_f32_np(p) for p in pieces])


def full_chunk_rounds(take: Dict[int, np.ndarray], pos: Dict[int, int], chunk: int) -> list:
    """The rounds of full chunks in the claimed audio ``take`` from each
    slot's position ``pos``: ``[{slot: (chunk,) array}, ...]``, a slot in
    every round until its audio has less than a chunk left."""
    rounds, rpos = [], dict(pos)
    while True:
        chunks = {b: a[rpos[b]: rpos[b] + chunk] for b, a in take.items()
                  if a.size - rpos[b] >= chunk}
        if not chunks:
            return rounds
        for b in chunks:
            rpos[b] += chunk
        rounds.append(chunks)


class StreamPool:
    """A pool of ``slots`` concurrent streams with join/leave lifecycle.

    Typical serving loop::

        pool = StreamPool(model, slots=32, chunk_samples=48000)
        a = pool.join(); b = pool.join()
        out = pool.push({a: chunk_a, b: chunk_b})   # {slot: (frames, classes)}
        tail = pool.leave(a)                        # exact flush tail
        c = pool.join()                             # reuses a's slot
    """

    # Max rounds in one device call: bounds the staged upload at
    # ROUNDS_PER_CALL * slots * chunk samples.
    ROUNDS_PER_CALL = 16

    def __init__(
        self,
        model: torch.nn.Module,
        cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
        slots: int = 8,
        chunk_samples: int = 48000,
        halo: int = 64,
        total_stride: int = 8,
        bucket: int = 128,
        mean: Optional[np.ndarray] = None,
        std: Optional[np.ndarray] = None,
        mesh=None,
        featurizer: str = "auto",
        featurizer_precision=None,
        extract_impl: str = "slices",
        qparams=None,
        device="cuda",
    ):
        """``featurizer``: 'auto', 'pallas' (K3 + K2) or 'xla' (PyTorch ops;
        see ``device_streaming.resolve_tick_featurizer``) for the tick and the
        host startup and drains alike; ``featurizer_precision``: None
        or 'parity' (K3), 'fast' or 'turbo' (K3t) or a raw 'bf16xN' string,
        for the tick, the startup and the drains alike (sed_tpu's startup
        stays at parity; ``featurizer='xla'`` ignores it); ``extract_impl``: 'slices' or 'span'; ``qparams``: an
        int8 serving artifact (``models.quantize``), scored by the tick,
        the startup and the drains alike; ``mesh``: this rank's slice of the
        slots on ``mesh.device`` (``device`` is not used; ``slots`` must
        divide by the mesh size, and an explicit 'pallas' is refused)."""
        if mesh is not None and slots % mesh.size != 0:
            raise ValueError(
                f"slots {slots} must divide over the {mesh.size}-device mesh")
        featurizer = resolve_tick_featurizer(featurizer, cfg, mesh)
        precision = resolve_featurizer_precision(featurizer_precision)
        self.device = resolve_device(device) if mesh is None else mesh.device
        self._mesh = mesh
        self._rows = local_rows(mesh, int(slots))
        self.cfg = cfg
        self.slots = int(slots)
        self.chunk = int(chunk_samples)
        self.halo = halo
        self.stride = total_stride
        self._model = model
        (self._frames_max, self._emit_max, self._m,
         self._l) = ring_geometry(cfg, self.chunk, halo, total_stride, bucket)
        self._switch_after = cfg.nfft + cfg.hop_size
        self.mean = None if mean is None else np.asarray(mean, np.float32)
        self.std = None if std is None else np.asarray(std, np.float32)

        # Per-slot host state.  A slot is one of:
        #   free      - available for join()
        #   pending   - joined, running host-side startup (self._pending[b])
        #   admitted  - state lives in the device ring rows
        # One (featurize, forward) pair serves every host detector the pool
        # builds (join startup, leave drain) and the ring tick.
        self._stream_fns = make_stream_fns(model, cfg, mean=self.mean,
                                           std=self.std, qparams=qparams,
                                           device=self.device, featurizer=featurizer,
                                           precision=precision)
        self._pending: Dict[int, BatchedStreamingDetector] = {}
        self._admitted: Dict[int, dict] = {}   # slot -> schedule counters
        # Staged audio is a per-slot list of fed pieces under its own lock,
        # so feed() can run in reader threads while a tick drives the device.
        self._staged: Dict[int, List[np.ndarray]] = {}
        self._staged_n: Dict[int, int] = {}
        self._stage_lock = threading.Lock()
        # Scores a failed tick had already computed (fault R2, see tick()),
        # delivered by the next tick() or by the slot's leave.
        self._undelivered: Dict[int, List[np.ndarray]] = {}
        # Optional per-phase profile accumulator (set to {} to enable):
        # pending-startup rounds, block build, upload and device time, the
        # round mix and upload bytes.  Profiling synchronizes after the
        # upload to split it from the ticks; leave it None in production.
        self.profile: Optional[dict] = None

        local = self._rows.stop - self._rows.start
        self._buf = torch.zeros(local, self._l, device=self.device)
        self._mel = torch.zeros(local, self._m, cfg.mel_bins, device=self.device)
        self._tick = RingTick(*self._stream_fns, cfg, self.chunk,
                              self._frames_max, self._emit_max, self._m,
                              extract_impl)

    # -- lifecycle -----------------------------------------------------------

    def _host_detector(self, **state) -> BatchedStreamingDetector:
        kw = dict(batch=1, halo=self.halo, total_stride=self.stride,
                  bucket=self._m, mean=self.mean, std=self.std,
                  stream_fns=self._stream_fns)
        if state:
            return BatchedStreamingDetector.from_state(self._model, self.cfg,
                                                       **kw, **state)
        return BatchedStreamingDetector(self._model, self.cfg, **kw)

    def join(self) -> int:
        """Take a free slot for a new stream; returns the slot id.  The
        stream's audio starts with its first chunk."""
        for b in range(self.slots):
            if b not in self._pending and b not in self._admitted:
                self._pending[b] = self._host_detector()
                return b
        raise RuntimeError(f"all {self.slots} slots are occupied")

    def _admit(self, b: int) -> None:
        """Move a pending stream's host state into slot ``b``'s ring rows.
        ``b`` enters ``_admitted`` before it leaves ``_pending``, so a
        concurrent feed() never finds the slot in neither."""
        h = self._pending[b]
        t_total = h._buf_start + h._samples.shape[1]
        counters = {"t_total": t_total, "n_frames": h._n_frames,
                    "emitted": h._emitted, "mel_start": h._mel_start}
        buf_row = np.zeros(self._l, np.float32)
        lo = t_total - self._l
        src_lo = max(h._buf_start, lo)
        buf_row[src_lo - lo:] = h._samples[0, src_lo - h._buf_start:]
        mel_row = np.zeros((self._m, self.cfg.mel_bins), np.float32)
        n = h._n_frames - h._mel_start
        mel_row[:n] = h._frames_mel[0, :n]
        if self._rows.start <= b < self._rows.stop:   # the slot's owning rank
            self._buf[b - self._rows.start] = torch.from_numpy(buf_row).to(self.device)
            self._mel[b - self._rows.start] = torch.from_numpy(mel_row).to(self.device)
        self._admitted[b] = counters
        self._pending.pop(b)

    def leave(self, b: int) -> np.ndarray:
        """End stream ``b``: exact tail through the host flush (audio still
        staged by :meth:`feed` is scored first); frees the slot.  Returns the
        (frames, classes) tail block, preceded by any scores a failed tick
        left undelivered."""
        early = self._undelivered.pop(b, [])
        h, rem = self._checkout(b)
        if h is None:  # never received audio: nothing to flush
            tail = np.zeros((0, self.cfg.classes_num), np.float32)
        else:
            if rem is not None and rem.size:
                h.stage(ingest_to_f32_np(rem)[None])
            tail = h.flush()[0]
        return np.concatenate(early + [tail], axis=0) if early else tail

    def _checkout(self, b: int):
        """Pop slot ``b`` and rebuild its host detector without scoring
        anything; returns ``(detector | None, staged_remainder)`` (None when
        the stream never received audio).  Frees the slot either way."""
        with self._stage_lock:
            pieces = self._staged.pop(b, None)
            self._staged_n.pop(b, None)
        rem = flatten_pieces(pieces) if pieces else None
        if b in self._pending:
            h = self._pending.pop(b)
            if (h._buf_start + h._samples.shape[1] == 0
                    and (rem is None or rem.size == 0)):
                return None, None
            return h, rem
        if b not in self._admitted:
            raise ValueError(f"slot {b} is not joined")
        c = self._admitted.pop(b)
        lo = max(0, c["t_total"] - self._l)
        buf_row = row_from_owner(self._mesh, self._buf, b).cpu().numpy()[None]
        mel_row = row_from_owner(self._mesh, self._mel, b).cpu().numpy()[None]
        h = self._host_detector(
            samples=buf_row[:, lo - (c["t_total"] - self._l):], buf_start=lo,
            n_frames=c["n_frames"],
            frames_mel=mel_row[:, : c["n_frames"] - c["mel_start"]],
            mel_start=c["mel_start"], emitted=c["emitted"])
        return h, rem

    def leave_many(self, slots) -> Dict[int, np.ndarray]:
        """Drain several leaving streams with shared device calls: one
        featurize over every stream's remaining frames and one stacked
        forward per distinct tail-window length.  Per-slot results equal
        :meth:`leave`.

        Returns ``{slot: (frames, classes) ndarray}``; a stream too short to
        featurize maps to an empty ``(0, classes)`` block; any other per-slot
        host-side failure maps to the exception instance, so one bad stream
        does not abort the batch.  Device faults propagate.

        (``sed_tpu`` pads each stacked forward to the pool size so that jit
        compiles one program per window length; eager PyTorch compiles
        nothing, so the stack holds only the leaving streams.)"""
        empty = np.zeros((0, self.cfg.classes_num), np.float32)
        tails: Dict[int, np.ndarray] = {}
        early: Dict[int, List[np.ndarray]] = {}
        dets: Dict[int, BatchedStreamingDetector] = {}
        frames: Dict[int, np.ndarray] = {}
        for b in list(slots):
            early[b] = self._undelivered.pop(b, [])
            try:
                h, rem = self._checkout(b)
                if h is None:
                    tails[b] = empty
                    continue
                if rem is not None and rem.size:
                    h.stage(ingest_to_f32_np(rem)[None])
                frames[b] = h._final_frames()
                dets[b] = h
            except ValueError as e:
                tails[b] = empty if "too short" in str(e) else e
            except Exception as e:  # noqa: BLE001 - host-side prep fault
                tails[b] = e

        order = [b for b in dets if frames[b].shape[1]]
        if order:
            lms = self._featurize_shared([frames[b][0] for b in order])
            for b, lm in zip(order, lms):
                dets[b]._install_final(lm[None])

        groups: Dict[int, list] = {}
        for b, h in dets.items():
            fw = h._final_window()
            if fw is None:
                tails[b] = empty
                continue
            groups.setdefault(fw[0].shape[1], []).append((b, fw))
        for members in groups.values():
            stack = np.concatenate([fw[0] for _, fw in members], axis=0)
            scores = self._stream_fns[1](torch.from_numpy(stack)[:, None]).cpu().numpy()
            for i, (b, (_, s, upto, pad_l)) in enumerate(members):
                tails[b] = dets[b]._final_trim(scores[i:i + 1], s, upto, pad_l)[0]
        for b, blocks in early.items():
            if blocks and isinstance(tails[b], np.ndarray):
                tails[b] = np.concatenate(blocks + [tails[b]], axis=0)
        return tails

    def _featurize_shared(self, rows) -> list:
        """One featurize call over concatenated ``(k_i, nfft)`` row blocks;
        returns the per-block log-mel.  Featurizing is row-independent, so
        batching across streams is exact.  (``sed_tpu`` cuts the rows into
        8- and 64-row blocks for jit's compile cache; eager PyTorch has
        none.)"""
        lm = self._stream_fns[0](torch.from_numpy(np.concatenate(rows, axis=0)))
        return np.split(lm.cpu().numpy(), np.cumsum([len(r) for r in rows])[:-1])

    # -- variable-size input: host staging over the fixed-chunk tick ---------

    def feed(self, b: int, samples: np.ndarray) -> None:
        """Stage any number of samples (int16 PCM, uint8 µ-law or float32,
        1-D) for slot ``b``.  No device work happens here: :meth:`tick`
        scores every slot with a full chunk staged, and :meth:`leave` drains
        a partial remainder exactly.

        Thread-safe: reader threads may feed while one thread drives the
        device (tick/push/join/leave); every other method needs external
        serialization.  Drive a slot through either feed()/tick() or raw
        :meth:`push`, not both interleaved."""
        if b not in self._pending and b not in self._admitted:
            raise ValueError(f"slot {b} is not joined")
        arr = np.asarray(samples)
        if arr.ndim != 1:
            raise ValueError(f"samples must be 1-D, got shape {arr.shape}")
        if arr.size == 0:
            return
        with self._stage_lock:
            self._staged.setdefault(b, []).append(arr.copy())
            self._staged_n[b] = self._staged_n.get(b, 0) + int(arr.size)

    def staged(self, b: int) -> int:
        """Samples staged for slot ``b`` and not yet claimed by a tick."""
        with self._stage_lock:
            return self._staged_n.get(b, 0)

    def _prof(self, **kv) -> None:
        if self.profile is not None:
            for k, v in kv.items():
                self.profile[k] = self.profile.get(k, 0) + v

    def tick(self) -> Dict[int, np.ndarray]:
        """Score one chunk for every slot with a full chunk staged, repeating
        until no slot has a full chunk left.  Rounds that involve a pending
        stream go through per-round :meth:`push` (startup and admission
        interleave rounds); the admitted-only rounds go up to
        ROUNDS_PER_CALL at a time through :meth:`_push_rounds`.  Returns
        ``{slot: (frames, classes)}`` for the slots that advanced.

        The tick claims a snapshot of the staged audio under the stage lock,
        so readers keep feeding meanwhile; unconsumed samples go back to the
        front of the staging queue.

        Divergence from ``sed_tpu`` (fault R2): when a round raises, the
        scores of the rounds already scored, whose samples are consumed, are
        kept and returned by the next tick() (or by the slot's leave) before
        the exception propagates; ``sed_tpu`` dropped them with it."""
        out: Dict[int, list] = self._undelivered
        self._undelivered = {}
        with self._stage_lock:
            take: Dict[int, np.ndarray] = {}
            for b in list(self._staged):
                if self._staged_n.get(b, 0) >= self.chunk:
                    take[b] = flatten_pieces(self._staged.pop(b))
                    self._staged_n[b] = 0
        pos = {b: 0 for b in take}
        ok = False
        try:
            t0 = time.perf_counter()
            while True:
                chunks = {b: a[pos[b]: pos[b] + self.chunk]
                          for b, a in take.items()
                          if a.size - pos[b] >= self.chunk}
                if not chunks or not any(b in self._pending for b in chunks):
                    break
                o = self.push(chunks)
                self._prof(pending_rounds=1)
                for b in chunks:
                    pos[b] += self.chunk
                    out.setdefault(b, []).append(o[b])
            self._prof(pending_s=time.perf_counter() - t0)
            rounds = full_chunk_rounds(take, pos, self.chunk)
            for j in range(0, len(rounds), self.ROUNDS_PER_CALL):
                block = rounds[j: j + self.ROUNDS_PER_CALL]
                o = self._push_rounds(block)
                for r in block:
                    for b in r:
                        pos[b] += self.chunk
                for b, v in o.items():
                    out.setdefault(b, []).append(v)
            ok = True
        finally:
            with self._stage_lock:
                for b, a in take.items():
                    rem = a[pos[b]:]
                    pieces = ([rem] if rem.size else []) + (self._staged.get(b) or [])
                    if pieces:
                        self._staged[b] = pieces
                        self._staged_n[b] = sum(int(p.size) for p in pieces)
            if not ok:
                self._undelivered = out
        return {b: (np.concatenate(v, axis=0) if len(v) > 1 else v[0])
                for b, v in out.items()}

    def _push_rounds(self, rounds) -> Dict[int, np.ndarray]:
        """Score K consecutive full-chunk rounds of admitted slots in one
        device call: the real chunks (only those) and every round's schedule
        go up in one upload each, the K ticks run back to back on the
        device, and the scores come down in one copy.  Counters advance on a
        copy and commit only after the call returns, so a fault leaves the
        pool consistent.  Scores equal sequential push() rounds (the same
        schedule rows through the same tick).

        (``sed_tpu`` pads K to ROUNDS_PER_CALL with no-op rounds and the
        upload to a power-of-4 row count, to bound jit's compiled programs;
        eager PyTorch compiles nothing, so only real rounds and chunks go.)

        Under a mesh every rank computes every slot's schedule and uploads
        the chunks and schedule rows of its own slots only."""
        if not all(b in self._admitted for r in rounds for b in r):
            raise ValueError("_push_rounds takes admitted slots only")
        t0 = time.perf_counter()
        B, F, K = self.slots, self._frames_max, len(rounds)
        lo, hi = self._rows.start, self._rows.stop
        counters = {b: dict(c) for b, c in self._admitted.items()}
        sched = np.zeros((K, B, F + SCHEDULE_SCALARS), np.int64)
        idx = np.zeros((K, hi - lo), np.int64)
        emit_n: List[Dict[int, int]] = [{} for _ in range(K)]
        cells = [(k, b) for k, r in enumerate(rounds) for b in r]
        mine = [(k, b) for k, b in cells if lo <= b < hi]
        dt = wire_dtype([rounds[k][b] for k, b in cells])
        wire = np.zeros((max(1, len(mine)), self.chunk), dt)
        for k, b in cells:
            (offs, n_new, write_pos, win_off, e_off, shift, emit_n[k][b],
             counters[b]) = tick_schedule(
                 counters[b], self.chunk, F, self._emit_max, self._m, self._l,
                 self.cfg, self.stride, self.halo)
            sched[k, b] = schedule_row(offs, n_new, write_pos, win_off, e_off, shift)
        for j, (k, b) in enumerate(mine):
            ck = rounds[k][b]
            wire[j] = ck if ck.dtype == dt else ingest_to_f32_np(ck)
            idx[k, b - lo] = j  # idle cells gather row 0; their rows are no-ops
        sched = np.ascontiguousarray(sched[:, lo:hi])

        t1 = time.perf_counter()
        wire_d = torch.from_numpy(wire).to(self.device)
        sched_d = torch.from_numpy(sched).to(self.device)
        idx_d = torch.from_numpy(idx).to(self.device)
        if self.profile is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # split the upload from the ticks
        t2 = time.perf_counter()
        buf, mel, outs = self._buf, self._mel, []
        for k in range(K):
            buf, mel, o = self._tick(buf, mel, wire_d[idx_d[k]], sched_d[k])
            outs.append(o)
        # (K, B, emit_max, classes), every rank's slots in slot order.
        dev_out = gather_rows(self._mesh, torch.stack(outs), dim=1).cpu().numpy()
        self._buf, self._mel = buf, mel
        self._prof(blocks=1, rounds_real=K, chunks_real=len(cells),
                   h2d_bytes=wire.nbytes + sched.nbytes + idx.nbytes,
                   build_s=t1 - t0, h2d_s=t2 - t1,
                   exec_s=time.perf_counter() - t2)
        out: Dict[int, list] = {}
        for k, r in enumerate(rounds):
            for b in r:
                out.setdefault(b, []).append(dev_out[k, b, : emit_n[k][b]])
        self._admitted.update(counters)
        return {b: (np.concatenate(v, axis=0) if len(v) > 1 else v[0])
                for b, v in out.items()}

    # -- tick ----------------------------------------------------------------

    def push(self, chunks: Dict[int, np.ndarray]) -> Dict[int, np.ndarray]:
        """Feed one ``(chunk_samples,)`` chunk, int16 PCM, uint8 µ-law or
        float32, for any subset of the joined streams; returns ``{slot:
        (frames, classes)}`` newly finalized scores for the slots that
        pushed.  A joined slot absent from ``chunks`` idles: its rings,
        counters and scores are untouched."""
        joined = set(self._pending) | set(self._admitted)
        extra = set(chunks) - joined
        if extra:
            raise ValueError(f"push for non-joined slots {sorted(extra)} "
                             f"(joined: {sorted(joined)})")
        # Validate every chunk before any state changes: raising after a
        # pending stream consumed its chunk would desync it on a retry.
        arrs: Dict[int, np.ndarray] = {}
        for b in chunks:
            ck = np.asarray(chunks[b])
            if ck.shape != (self.chunk,):
                raise ValueError(f"slot {b}: chunk must be ({self.chunk},), "
                                 f"got {ck.shape}")
            arrs[b] = ck
        out: Dict[int, np.ndarray] = {}

        # 1. pending streams: host-side startup, every pending slot's new
        # frames featurized in one call.  Admission waits until after the
        # device tick (3): the tick shifts every active ring row.
        to_admit = []
        pend = [b for b in self._pending if b in arrs]
        news = {}
        for b in pend:
            h = self._pending[b]
            h.stage(ingest_to_f32_np(arrs[b])[None])
            news[b] = h._new_frames()
        framed = [b for b in pend if news[b].shape[1]]
        if framed:
            lms = self._featurize_shared([news[b][0] for b in framed])
            for b, lm in zip(framed, lms):
                self._pending[b]._install_new(lm[None])
        for b in pend:
            h = self._pending[b]
            if b not in framed:
                h._install_new(news[b][:, :0, :])  # trim raw samples only
            out[b] = h._emit()[0]
            if h._buf_start + h._samples.shape[1] >= self._switch_after:
                to_admit.append(b)

        # 2. admitted streams that pushed: one device tick.
        ticking = {b: arrs[b] for b in self._admitted if b in arrs}
        if ticking:
            out.update(self._push_rounds([ticking]))

        # 3. streams whose startup completed this tick join the device ring.
        for b in to_admit:
            self._admit(b)
        return out
