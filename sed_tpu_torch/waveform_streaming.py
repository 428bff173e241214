"""Streaming inference for the waveform (M5) model family (counterpart of
``sed_tpu.waveform_streaming``).

M5 scores each hop-strided frame independently (a global mean over time
inside the frame), so streaming needs no halo: a rolling sample buffer
emits one score per completed frame, frame i covering samples
``[i*hop, i*hop + 2*(frame_size//2))`` as the offline validation split
(``cli/infer.hop_frames``) does.  A frame's score is final the moment its
last sample arrives, and equals the offline score of that frame.

  * :class:`BatchedWaveformStreamingDetector` / :class:`WaveformStreamingDetector`
    — host rolling buffers, frames scored in fixed buckets;
  * :class:`WaveformStreamPool` — per-slot host buffers, one shared scorer
    over every slot's frames;
  * :class:`DeviceWaveformStreamPool` — per-slot rows of a sample ring on
    the device: a tick uploads the raw chunks (int16 PCM and uint8 µ-law are
    decoded on the device), cuts each slot's new frames from its ring row and
    scores them in the same call.

The model is a ``torch.nn.Module`` holding its weights, in the place of
``sed_tpu``'s (model, params, batch_stats) triple.  Every scoring call puts
it in eval mode and runs in full float32 (``utils.precision.full_float32``).
No featurizer kernel runs here: M5 reads samples.  ``qparams`` switches the
forward to the int8 M5 path (``models.quantize.quantized_m5_forward``), a
lossy serving mode with the same contract.  ``DeviceWaveformStreamPool``
takes a ``mesh`` (``parallel.mesh``) and shards its slots over the ranks.
"""

from __future__ import annotations

import threading
from typing import Dict, List

import numpy as np
import torch

from sed_tpu_torch.configs import DEFAULT_WAVEFORM, WaveformConfig
from sed_tpu_torch.inference import resolve_device
from sed_tpu_torch.models.quantize import qparams_to, quantized_m5_forward
from sed_tpu_torch.ops.featurizer import ingest_to_f32, ingest_to_f32_np
from sed_tpu_torch.stream_pool import flatten_pieces, full_chunk_rounds, wire_dtype
from sed_tpu_torch.parallel.mesh import gather_rows, local_rows, row_from_owner
from sed_tpu_torch.utils.precision import full_float32

# Rows of one leave-time scoring block (sed_tpu's tail block).
TAIL_ROWS = 64


def make_m5_score_fn(model: torch.nn.Module, qparams=None, device="cuda"):
    """One ``score(frames) -> scores`` function for every detector and slot
    of one model: (n, frame) float32 array or tensor -> (n, classes) sigmoid
    scores, a tensor on ``device``.  ``model`` is moved to ``device``; each
    call puts it in eval mode, leaves it there, and runs in full float32; a
    bf16-tier M5 (``dtype=torch.bfloat16``) computes its forward in bfloat16
    on the float32 frames and returns float32 scores.  With ``qparams`` (``models.quantize.quantize_m5``'s artifact, moved to
    ``device``) it scores through the int8 forward instead."""
    device = resolve_device(device)
    if qparams is not None:
        qparams = qparams_to(qparams, device)

        def score_int8(frames) -> torch.Tensor:
            x = torch.as_tensor(frames, device=device)[:, None, :]
            return torch.sigmoid(quantized_m5_forward(qparams, x))

        return score_int8
    model = model.to(device)

    @torch.no_grad()
    @full_float32()
    def score(frames) -> torch.Tensor:
        model.eval()
        return torch.sigmoid(model(torch.as_tensor(frames, device=device)[:, None, :]))

    return score


def _score_rows(score, rows: np.ndarray, block: int) -> np.ndarray:
    """Score (n, frame) rows in blocks of ``block`` rows, the last one
    zero-padded, so every call has one shape: (n, classes) numpy."""
    n = rows.shape[0]
    outs = []
    for j in range(0, n, block):
        blk = rows[j:j + block]
        if blk.shape[0] != block:
            blk = np.concatenate([blk, np.zeros((block - blk.shape[0], blk.shape[1]),
                                                np.float32)])
        outs.append(score(torch.from_numpy(np.ascontiguousarray(blk))).cpu().numpy())
    return np.concatenate(outs)[:n]


class BatchedWaveformStreamingDetector:
    """B lockstep waveform streams; push any number of samples per call.

    Returns (batch, new_frames, classes) sigmoid scores per push: the frames
    whose last sample arrived in this chunk.  There is no flush: the offline
    split drops the partial tail (no end padding).
    """

    def __init__(self, model: torch.nn.Module, cfg: WaveformConfig = DEFAULT_WAVEFORM,
                 batch: int = 1, frame_bucket: int = 8, qparams=None, score_fn=None,
                 device="cuda"):
        """``qparams``: an int8 M5 artifact, scored through the int8
        forward.  ``score_fn``: a shared scorer from :func:`make_m5_score_fn`
        (built with the same model and qparams); it decides the device, and
        ``device`` is then unused."""
        self.cfg = cfg
        self.batch = int(batch)
        self._frame = 2 * (cfg.frame_size // 2)
        self._hop = cfg.hop_size
        self._bucket = int(frame_bucket)
        self._total = 0     # samples received
        self._emitted = 0   # frames scored
        # Everything not yet consumed by a frame; sample index of
        # _buf[:, 0] is emitted * hop.
        self._buf = np.zeros((self.batch, 0), np.float32)
        self._score = score_fn if score_fn is not None else make_m5_score_fn(
            model, qparams, device=device)

    def _ready(self, total: int) -> int:
        return 0 if total < self._frame else (total - self._frame) // self._hop + 1

    def extract_ready(self, chunk: np.ndarray) -> np.ndarray:
        """Consume ``chunk`` (float32, int16 PCM or uint8 µ-law, decoded on
        the host) and return the newly completed hop-strided frames,
        (batch, k, frame) float32, without scoring them."""
        chunk = ingest_to_f32_np(chunk).reshape(self.batch, -1)
        self._buf = np.concatenate([self._buf, chunk], axis=1)
        self._total += chunk.shape[1]
        k = self._ready(self._total) - self._emitted
        if k <= 0:
            return np.zeros((self.batch, 0, self._frame), np.float32)
        # Frame views of the buffer; they keep the untrimmed buffer alive.
        win = np.lib.stride_tricks.sliding_window_view(self._buf, self._frame, axis=1)
        frames = win[:, ::self._hop][:, :k]
        self._emitted += k
        self._buf = self._buf[:, k * self._hop:]
        return frames

    def push(self, chunk: np.ndarray) -> np.ndarray:
        """(batch, samples) float32, int16 PCM (1/32768) or uint8 µ-law,
        any sample count, the same for every row."""
        frames = self.extract_ready(chunk)
        k = frames.shape[1]
        if k == 0:
            return np.zeros((self.batch, 0, self.cfg.classes_num), np.float32)
        # Fixed blocks of frame_bucket frames a stream: one shape for cuDNN
        # however large the push.
        fb, outs = self._bucket, []
        for j in range(0, k, fb):
            blk = frames[:, j:j + fb]
            if blk.shape[1] != fb:
                blk = np.concatenate([blk, np.zeros((self.batch, fb - blk.shape[1],
                                                     self._frame), np.float32)], axis=1)
            flat = torch.from_numpy(np.ascontiguousarray(
                blk.reshape(self.batch * fb, self._frame)))
            outs.append(self._score(flat).cpu().numpy().reshape(self.batch, fb, -1))
        return np.concatenate(outs, axis=1)[:, :k]


class WaveformStreamingDetector(BatchedWaveformStreamingDetector):
    """Single live waveform stream: push (samples,), get (frames, classes)."""

    def __init__(self, model: torch.nn.Module, cfg: WaveformConfig = DEFAULT_WAVEFORM,
                 frame_bucket: int = 8, qparams=None, score_fn=None, device="cuda"):
        super().__init__(model, cfg, batch=1, frame_bucket=frame_bucket,
                         qparams=qparams, score_fn=score_fn, device=device)

    def push(self, chunk: np.ndarray) -> np.ndarray:
        return super().push(np.asarray(chunk).reshape(1, -1))[0]


class WaveformStreamPool:
    """A pool of M5 streams with host buffers, behind the surface
    :class:`sed_tpu_torch.serve_socket.StreamServer` drives
    (``join``/``feed``/``tick``/``leave``/``leave_many``,
    ``THREAD_SAFE_FEED``).

    Each slot keeps its own rolling buffer (a
    :class:`WaveformStreamingDetector`); :meth:`tick` scores every slot's
    newly completed frames together, in shared blocks of ``frame_bucket``
    rows (frames are independent rows to M5, so batching across slots is
    exact).  The block shape equals the detectors', so the scores are equal.
    """

    THREAD_SAFE_FEED = True
    # No fixed chunk: feed() takes any length and frames finalize per hop.
    chunk = None

    def __init__(self, model: torch.nn.Module, cfg: WaveformConfig = DEFAULT_WAVEFORM,
                 slots: int = 8, frame_bucket: int = 8, qparams=None, device="cuda"):
        self.cfg = cfg
        self.slots = int(slots)
        self._bucket = int(frame_bucket)
        self._score = make_m5_score_fn(model, qparams, device=device)
        self.device = resolve_device(device)
        self._make = lambda: WaveformStreamingDetector(
            model, cfg, frame_bucket=frame_bucket, score_fn=self._score)
        self._dets: dict = {}
        self._staged: dict = {}
        # feed() appends under this lock so reader threads can stage while
        # the ticker drives the device; every other method needs external
        # serialization.
        self._stage_lock = threading.Lock()

    def join(self) -> int:
        for b in range(self.slots):
            if b not in self._dets:
                self._dets[b] = self._make()
                self._staged[b] = []
                return b
        raise RuntimeError(f"all {self.slots} slots are occupied")

    def feed(self, b: int, samples: np.ndarray) -> None:
        """Stage 1-D samples (float32, int16 PCM or uint8 µ-law; decoded on
        the host: the ticks ship overlapping frames, not the wire bytes)."""
        if b not in self._dets:
            raise ValueError(f"slot {b} is not joined")
        arr = np.asarray(samples)
        if arr.ndim != 1:
            raise ValueError(f"samples must be 1-D, got shape {arr.shape}")
        arr = ingest_to_f32_np(arr)
        with self._stage_lock:
            self._staged[b].append(arr)

    def _take(self, b: int):
        """Slot ``b``'s staged pieces as one (1, n) array, or None."""
        with self._stage_lock:
            pieces = self._staged.get(b)
            if not pieces:
                return None
            self._staged[b] = []
        return np.concatenate(pieces)[None]

    def _scatter(self, per) -> dict:
        """Score ``[(slot, (k, frame) frames), ...]`` in shared blocks;
        ``{slot: (k, classes)}``."""
        scores = _score_rows(self._score, np.concatenate([f for _, f in per]), self._bucket)
        out, pos = {}, 0
        for b, f in per:
            out[b] = scores[pos:pos + f.shape[0]]
            pos += f.shape[0]
        return out

    def tick(self) -> dict:
        """Score every completed frame of every slot's staged audio;
        ``{slot: (frames, classes)}`` for the slots that completed one."""
        per = []
        for b in list(self._staged):
            pieces = self._take(b)
            if pieces is None:
                continue
            frames = self._dets[b].extract_ready(pieces)
            if frames.shape[1]:
                per.append((b, frames[0]))
        return self._scatter(per) if per else {}

    def leave(self, b: int) -> np.ndarray:
        """End stream ``b``: score the frames its staged audio completes (the
        sub-frame remainder is dropped, as offline) and free the slot."""
        if b not in self._dets:
            raise ValueError(f"slot {b} is not joined")
        with self._stage_lock:
            pieces = self._staged.pop(b)
        det = self._dets.pop(b)
        if pieces:
            return det.push(np.concatenate(pieces))
        return np.zeros((0, self.cfg.classes_num), np.float32)

    def leave_many(self, slots) -> dict:
        """Drain several leaving streams, their tail frames in the shared
        blocks of :meth:`tick`.  ``{slot: (frames, classes)}``; a per-slot
        host-side failure maps to the exception instance."""
        empty = np.zeros((0, self.cfg.classes_num), np.float32)
        per, tails = [], {}
        for b in list(slots):
            try:
                if b not in self._dets:
                    raise ValueError(f"slot {b} is not joined")
                with self._stage_lock:
                    pieces = self._staged.pop(b)
                det = self._dets.pop(b)
                frames = det.extract_ready(np.concatenate(pieces)[None]) if pieces else None
                if frames is not None and frames.shape[1]:
                    per.append((b, frames[0]))
                else:
                    tails[b] = empty
            except Exception as e:  # noqa: BLE001 - per-slot host-side fault
                tails[b] = e
        if per:
            tails.update(self._scatter(per))
        return tails


class DeviceWaveformStreamPool:
    """M5 serving pool whose sample rings live on the device (the default
    ``--m5_pool device``).

    :class:`WaveformStreamPool` ships extracted float32 frames, which
    overlap by half: 8 bytes of upload a sample of int16 audio.  Here each
    slot owns a row of a (slots, L) sample ring, L = chunk + frame + hop.  A
    tick uploads one raw ``chunk_samples`` block per pushing slot (int16 PCM
    or uint8 µ-law ride as they are and are decoded on the device by
    ``ingest_to_f32``), shifts those rows, cuts up to F = (chunk - 1) // hop
    + 1 new frames a slot from its row, and scores them in the same call.

    Every round scores a fixed (slots * F)-row block, whatever the number of
    new frames: rows without a new frame (idle slots, F beyond a slot's
    count) are scored and dropped by the host, as ``sed_tpu`` does, so cuDNN
    sees one shape.  Backlogs of several chunks go in blocks of up to
    ROUNDS_PER_CALL rounds: one upload of the real chunks (only those, as
    ``stream_pool.StreamPool`` does) and of the schedule, the rounds back to
    back on the device, one download of the scores.

    M5 needs none of the spectrogram pool's startup: frames start at sample
    0, each is independent, so a slot is on the ring from its join; the host
    scores only the sub-chunk remainder at leave.  Same
    ``join/feed/tick/push/leave/leave_many`` surface as the host pool.

    ``mesh`` (``parallel.mesh``): the slot axis of the ring and of every
    round shards over the ranks, each scoring its slots' frames on
    ``mesh.device`` (``device`` is not used), and the scores are gathered on
    every rank; ``slots`` must divide by the mesh size.  Backlogs run as
    single-round calls under a mesh, as ``sed_tpu``'s do.  The host
    schedule runs identically on every rank (the SPMD contract).
    """

    THREAD_SAFE_FEED = True
    ROUNDS_PER_CALL = 16

    def __init__(self, model: torch.nn.Module, cfg: WaveformConfig = DEFAULT_WAVEFORM,
                 slots: int = 8, chunk_samples=None, qparams=None, mesh=None,
                 device="cuda"):
        if mesh is not None and int(slots) % mesh.size != 0:
            raise ValueError(
                f"slots {int(slots)} must divide over the {mesh.size}-device mesh")
        self.cfg = cfg
        self.slots = int(slots)
        self.chunk = C = int(chunk_samples or cfg.working_sample_rate)
        self._frame = 2 * (cfg.frame_size // 2)
        self._hop = cfg.hop_size
        if C < self._frame:
            # A chunk that starts mid-frame must still complete the frame
            # ending inside it; C >= frame keeps F small and the ring bound
            # simple.
            raise ValueError(f"chunk_samples {C} < frame {self._frame}")
        self._F = (C - 1) // self._hop + 1       # most frames a chunk completes
        self._L = C + self._frame + self._hop    # ring length
        self.device = resolve_device(device) if mesh is None else mesh.device
        self._mesh = mesh
        self._shard = local_rows(mesh, self.slots)
        local = self._shard.stop - self._shard.start
        self._score = make_m5_score_fn(model, qparams, device=self.device)
        self._buf = torch.zeros(local, self._L, device=self.device)
        self._rows = torch.arange(local, device=self.device)[:, None]
        self._counters: Dict[int, dict] = {}   # slot -> {"total", "emitted"}
        self._staged: Dict[int, List[np.ndarray]] = {}
        self._staged_n: Dict[int, int] = {}
        self._stage_lock = threading.Lock()

    # -- the device round -------------------------------------------------------

    @torch.no_grad()
    def _round(self, buf, chunk, active, offs):
        """One round: shift the active rows by their chunk, cut F frames a
        slot at its ring-relative ``offs`` (B, F), score the (B * F) block.
        Inactive rows stay bit-untouched.  B is this rank's slots."""
        B, F, C, frame = buf.shape[0], self._F, self.chunk, self._frame
        newc = ingest_to_f32(chunk)
        buf = torch.where(active[:, None], torch.cat([buf[:, C:], newc], dim=1), buf)
        frames = buf.unfold(1, frame, 1)[self._rows, offs]        # (B, F, frame)
        return buf, self._score(frames.reshape(B * F, frame)).reshape(B, F, -1)

    def _slot_scalars(self, c: dict):
        """One slot's ring-relative schedule for one chunk: its F frame
        offsets, its count of new frames and its counters after."""
        total2 = c["total"] + self.chunk
        ready = 0 if total2 < self._frame else (total2 - self._frame) // self._hop + 1
        n_new = ready - c["emitted"]
        offs = np.zeros(self._F, np.int64)
        offs[:n_new] = (c["emitted"] + np.arange(n_new)) * self._hop - (total2 - self._L)
        if not (0 <= n_new <= self._F and (offs >= 0).all()
                and (offs + self._frame <= self._L).all()):
            # The tick indexes the ring with these; an index outside it
            # would fault the card.
            raise ValueError(f"ring geometry violated: n_new={n_new}, offsets "
                             f"{offs.min()}..{offs.max()} for a ring of {self._L}")
        return offs, n_new, {"total": total2, "emitted": ready}

    def _push_rounds(self, rounds) -> dict:
        """K consecutive rounds (``[{slot: (chunk,) array}, ...]``) in one
        device call: the real chunks go up once, the K rounds run back to
        back, the scores come down once.  Counters commit after the call, so
        a fault leaves the pool consistent.  Under a mesh the rounds run one
        call each (``sed_tpu``'s sharded dispatch) and each rank uploads its
        own slots' chunks and schedule only."""
        if self._mesh is not None and len(rounds) > 1:
            out: dict = {}
            for r in rounds:
                for b, v in self._push_rounds([r]).items():
                    out.setdefault(b, []).append(v)
            return {b: (np.concatenate(v) if len(v) > 1 else v[0]) for b, v in out.items()}
        lo, hi = self._shard.start, self._shard.stop
        F, K = self._F, len(rounds)
        counters = {b: dict(c) for b, c in self._counters.items()}
        active = np.zeros((K, hi - lo), bool)
        offs = np.zeros((K, hi - lo, F), np.int64)
        idx = np.zeros((K, hi - lo), np.int64)
        emit_n = [dict() for _ in range(K)]
        cells = [(k, b) for k, r in enumerate(rounds) for b in r]
        dt = wire_dtype([rounds[k][b] for k, b in cells])
        mine = [(k, b) for k, b in cells if lo <= b < hi]
        wire = np.zeros((max(1, len(mine)), self.chunk), dt)
        for k, b in cells:
            o, emit_n[k][b], counters[b] = self._slot_scalars(counters[b])
            if lo <= b < hi:
                offs[k, b - lo] = o
        for j, (k, b) in enumerate(mine):
            ck = rounds[k][b]
            wire[j] = ck if ck.dtype == dt else ingest_to_f32_np(ck)
            idx[k, b - lo] = j     # idle cells gather row 0; their rows stay
            active[k, b - lo] = True
        wire_d = torch.from_numpy(wire).to(self.device)
        active_d = torch.from_numpy(active).to(self.device)
        offs_d = torch.from_numpy(offs).to(self.device)
        idx_d = torch.from_numpy(idx).to(self.device)
        buf, outs = self._buf, []
        for k in range(K):
            buf, o = self._round(buf, wire_d[idx_d[k]], active_d[k], offs_d[k])
            outs.append(o)
        # (K, B, F, classes), every rank's slots in slot order.
        dev_out = gather_rows(self._mesh, torch.stack(outs), dim=1).cpu().numpy()
        self._buf = buf
        out: dict = {}
        for k, r in enumerate(rounds):
            for b in r:
                out.setdefault(b, []).append(dev_out[k, b, :emit_n[k][b]])
        self._counters.update(counters)
        return {b: (np.concatenate(v) if len(v) > 1 else v[0]) for b, v in out.items()}

    # -- lifecycle ---------------------------------------------------------------

    def join(self) -> int:
        for b in range(self.slots):
            if b not in self._counters:
                # No ring reset: a fresh stream's frames read only samples
                # it pushed (off >= L - total).
                self._counters[b] = {"total": 0, "emitted": 0}
                return b
        raise RuntimeError(f"all {self.slots} slots are occupied")

    def feed(self, b: int, samples: np.ndarray) -> None:
        """Stage any number of samples (int16 PCM, uint8 µ-law or float32,
        1-D; µ-law is decoded on the device in the tick).  Thread-safe
        against a concurrent tick."""
        if b not in self._counters:
            raise ValueError(f"slot {b} is not joined")
        arr = np.asarray(samples)
        if arr.ndim != 1:
            raise ValueError(f"samples must be 1-D, got shape {arr.shape}")
        if arr.size == 0:
            return
        with self._stage_lock:
            self._staged.setdefault(b, []).append(arr.copy())
            self._staged_n[b] = self._staged_n.get(b, 0) + int(arr.size)

    def push(self, chunks: dict) -> dict:
        """One ``(chunk_samples,)`` block for any subset of the joined
        slots; ``{slot: (new_frames, classes)}``."""
        extra = set(chunks) - set(self._counters)
        if extra:
            raise ValueError(f"push for non-joined slots {sorted(extra)}")
        arrs = {}
        for b, ck in chunks.items():
            ck = np.asarray(ck)
            if ck.shape != (self.chunk,):
                raise ValueError(f"slot {b}: chunk must be ({self.chunk},), got {ck.shape}")
            arrs[b] = ck
        return self._push_rounds([arrs]) if arrs else {}

    def tick(self) -> dict:
        """Score every staged full chunk of every slot, backlogs in blocks of
        up to ROUNDS_PER_CALL rounds; unconsumed samples go back to the front
        of the staging queue.  ``{slot: (frames, classes)}``."""
        with self._stage_lock:
            take = {}
            for b in list(self._staged):
                if self._staged_n.get(b, 0) >= self.chunk:
                    take[b] = flatten_pieces(self._staged.pop(b))
                    self._staged_n[b] = 0
        if not take:
            return {}
        pos = {b: 0 for b in take}
        out: dict = {}
        try:
            rounds = full_chunk_rounds(take, pos, self.chunk)
            for j in range(0, len(rounds), self.ROUNDS_PER_CALL):
                block = rounds[j:j + self.ROUNDS_PER_CALL]
                o = self._push_rounds(block)
                for r in block:
                    for b in r:
                        pos[b] += self.chunk
                for b, v in o.items():
                    out.setdefault(b, []).append(v)
        finally:
            with self._stage_lock:
                for b, a in take.items():
                    rem = a[pos[b]:]
                    pieces = ([rem] if rem.size else []) + (self._staged.get(b) or [])
                    if pieces:
                        self._staged[b] = pieces
                        self._staged_n[b] = sum(int(p.size) for p in pieces)
        return {b: (np.concatenate(v) if len(v) > 1 else v[0]) for b, v in out.items()}

    # -- leave -------------------------------------------------------------------

    def _tail_frames(self, b: int, rem) -> np.ndarray:
        """The frames slot ``b``'s sub-chunk remainder completes, cut on the
        host from its ring row and the remainder: (k, frame)."""
        c = self._counters[b]
        total = c["total"]
        rem = ingest_to_f32_np(rem) if rem is not None else np.zeros(0, np.float32)
        total2 = total + rem.size
        ready = 0 if total2 < self._frame else (total2 - self._frame) // self._hop + 1
        k = ready - c["emitted"]
        if k <= 0:
            return np.zeros((0, self._frame), np.float32)
        row = row_from_owner(self._mesh, self._buf, b).cpu().numpy()
        hist = min(total, self._L)
        sig = np.concatenate([row[self._L - hist:], rem])
        base = total2 - sig.size                    # sample index of sig[0]
        starts = (c["emitted"] + np.arange(k)) * self._hop - base
        return np.stack([sig[s:s + self._frame] for s in starts])

    def _checkout(self, b: int) -> np.ndarray:
        """Pop slot ``b`` and return the frames its staged audio completes."""
        if b not in self._counters:
            raise ValueError(f"slot {b} is not joined")
        with self._stage_lock:
            pieces = self._staged.pop(b, None)
            self._staged_n.pop(b, None)
        frames = self._tail_frames(b, flatten_pieces(pieces) if pieces else None)
        del self._counters[b]
        return frames

    def leave(self, b: int) -> np.ndarray:
        """End stream ``b``: score the frames its staged remainder completes
        (the sub-frame tail is dropped, as offline) and free the slot."""
        frames = self._checkout(b)
        if not frames.shape[0]:
            return np.zeros((0, self.cfg.classes_num), np.float32)
        return _score_rows(self._score, frames, TAIL_ROWS)

    def leave_many(self, slots) -> dict:
        """Drain several leaving streams, their tail frames in shared blocks
        of TAIL_ROWS rows; a per-slot host-side failure maps to the exception
        instance."""
        empty = np.zeros((0, self.cfg.classes_num), np.float32)
        per, tails = [], {}
        for b in list(slots):
            try:
                frames = self._checkout(b)
                if frames.shape[0]:
                    per.append((b, frames))
                else:
                    tails[b] = empty
            except Exception as e:  # noqa: BLE001 - per-slot host-side fault
                tails[b] = e
        if per:
            scores = _score_rows(self._score, np.concatenate([f for _, f in per]), TAIL_ROWS)
            pos = 0
            for b, f in per:
                tails[b] = scores[pos:pos + f.shape[0]]
                pos += f.shape[0]
        return tails
