"""Device-resident batched streaming (counterpart of ``sed_tpu.device_streaming``).

The host-driven classes (:mod:`sed_tpu_torch.streaming`) frame on the host
and upload float32 frames every push.  Here the streaming state lives on the
device: a sample ring (B, L) and a log-mel ring (B, M, mel), and each tick
runs the five steps of :class:`RingTick`:

  1. shift the sample ring and append the new chunk (int16 PCM and uint8
     µ-law are decoded on the device, so the upload is 2 or 1 bytes/sample);
  2. gather the newly ready STFT frames from the ring;
  3. featurize them (K3 + K2 on CUDA, their plain versions on the CPU) and
     write them into the mel ring, masked to the new frames;
  4. score the emission window and cut out the newly finalized block;
  5. shift the mel ring for the next tick.

The host keeps only the schedule, the integer arithmetic of
:func:`sed_tpu_torch.streaming.tick_schedule`, and hands the tick its
offsets as one small index tensor.  The irregular stream start (reflect
padding) and the exact tail (flush) reuse the host class: the first pushes
run through a :class:`BatchedStreamingDetector`, whose state then moves into
the device rings; flush() moves it back.

Serving shape: B lockstep streams, a fixed chunk size per push.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sed_tpu_torch.configs import DEFAULT_SPECTROGRAM, SpectrogramConfig
from sed_tpu_torch.inference import resolve_device
from sed_tpu_torch.ops.featurizer import (ingest_to_f32, ingest_to_f32_np,
                                          resolve_featurizer_precision)
from sed_tpu_torch.streaming import (BatchedStreamingDetector, make_stream_fns,
                                     refuse_unported, tick_schedule)

# Columns of one slot's row of a tick schedule, after its frames_max frame
# offsets (see :func:`schedule_row`).
N_NEW, WRITE_POS, WIN_OFF, E_OFF, SHIFT, ACTIVE = range(6)
SCHEDULE_SCALARS = 6


def resolve_tick_featurizer(featurizer: str, cfg, mesh=None) -> str:
    """'auto' and 'pallas' -> 'pallas': the tick featurizes through the
    hand-written kernels K3 + K2 on CUDA and their plain versions on the
    CPU.  'xla' -> 'xla': ``sed_tpu``'s XLA tick featurizer, here the rFFT
    and mel projection in PyTorch ops (``ops.featurizer.logmel_frames_xla``),
    taken only when named.  A ``mesh`` raises ``NotImplementedError``."""
    refuse_unported(mesh=mesh)
    if featurizer in ("auto", "pallas"):
        return "pallas"
    if featurizer == "xla":
        return "xla"
    raise ValueError(f"featurizer must be auto|xla|pallas, got {featurizer}")


def ring_geometry(cfg, chunk: int, halo: int, total_stride: int, bucket: int):
    """``(frames_max, emit_max, ring_m, ring_l)`` of a tick of ``chunk``
    samples: new frames per tick, emitted frames per tick, mel-ring and
    sample-ring lengths."""
    hop = cfg.hop_size
    frames_max = -(-chunk // hop) + 1
    emit_max = total_stride * (-(-(frames_max + total_stride) // total_stride))
    need = 2 * halo + 2 * total_stride + frames_max
    ring_m = bucket * (-(-need // bucket))
    ring_l = chunk + cfg.nfft + hop
    return frames_max, emit_max, ring_m, ring_l


def schedule_row(offs, n_new, write_pos, win_off, e_off, shift) -> np.ndarray:
    """One active slot's tick schedule as a row of int64: its frame offsets,
    then the scalars in the order of the column constants above.  An
    all-zero row is an exact no-op tick for its slot: ``active`` 0 keeps
    the sample ring, ``n_new`` 0 masks the mel write, shift 0 keeps the mel
    ring."""
    return np.concatenate([np.asarray(offs, np.int64),
                           [n_new, write_pos, win_off, e_off, shift, 1]])


def rows_at(x: torch.Tensor, start: torch.Tensor, length: int) -> torch.Tensor:
    """``x[b, start[b] : start[b] + length]`` for every row b of a (B, N) or
    (B, N, C) tensor; the caller guarantees ``start + length <= N``."""
    rows = torch.arange(x.shape[0], device=x.device)
    out = x.unfold(1, length, 1)[rows, start]
    return out if x.ndim == 2 else out.movedim(-1, 1)


class RingTick:
    """One tick of the device rings for B slots, each at its own schedule
    phase (the step of ``sed_tpu``'s DeviceStreamingDetector and StreamPool,
    vmap written out as a batch dimension).

    ``extract_impl``: 'slices' gathers each frame at its own offset; 'span'
    gathers one contiguous span per slot and cuts hop-spaced frames from it
    (``tick_schedule`` keeps a slot's real frames hop-spaced; the masked
    tail reads zero padding).  Both give the same frames.
    """

    def __init__(self, featurize, forward, cfg: SpectrogramConfig, chunk: int,
                 frames_max: int, emit_max: int, ring_m: int,
                 extract_impl: str = "slices"):
        if extract_impl not in ("span", "slices"):
            raise ValueError(f"extract_impl must be span|slices, got {extract_impl}")
        self.featurize, self.forward = featurize, forward
        self.cfg = cfg
        self.chunk, self.frames_max = chunk, frames_max
        self.emit_max, self.ring_m = emit_max, ring_m
        self.extract_impl = extract_impl

    @torch.no_grad()
    def __call__(self, buf: torch.Tensor, mel: torch.Tensor, chunk: torch.Tensor,
                 sched: torch.Tensor):
        """``buf`` (B, L) f32, ``mel`` (B, M, mel) f32, ``chunk`` (B, C)
        float, int16 or uint8, ``sched`` (B, F + 6) int64 rows of
        :func:`schedule_row` -> ``(buf, mel, out)`` with ``out`` the
        (B, emit_max, classes) score block; slot b's first emit_n rows are
        its new scores."""
        cfg, F, M, C = self.cfg, self.frames_max, self.ring_m, self.chunk
        nfft, hop, B = cfg.nfft, cfg.hop_size, buf.shape[0]
        offs, scal = sched[:, :F], sched[:, F:]
        active = scal[:, ACTIVE] != 0

        # 1. sample ring shift + append, gated per slot.
        newc = ingest_to_f32(chunk)
        buf = torch.where(active[:, None], torch.cat([buf[:, C:], newc], dim=1), buf)

        # 2. the up-to-F newly ready frames of each slot.
        if self.extract_impl == "span":
            span_len = (F - 1) * hop + nfft
            ext = torch.cat([buf, buf.new_zeros(B, span_len - nfft)], dim=1)
            frames = rows_at(ext, offs[:, 0], span_len).unfold(1, nfft, hop)
        else:
            rows = torch.arange(B, device=buf.device)[:, None]
            frames = buf.unfold(1, nfft, 1)[rows, offs]           # (B, F, nfft)

        # 3. featurize and write the real frames into the mel ring.
        lm = self.featurize(frames.reshape(B * F, nfft)).reshape(B, F, -1)
        steps = torch.arange(F, device=buf.device)
        idx = (scal[:, WRITE_POS, None] + steps)[..., None].expand(-1, -1, mel.shape[2])
        keep = (steps[None, :] < scal[:, N_NEW, None])[..., None]
        mel = mel.scatter(1, idx, torch.where(keep, lm, mel.gather(1, idx)))

        # 4. score the emission window; zeros beyond the ring lie outside the
        # trusted region, the same exactness argument as the host class.
        ext = torch.cat([mel, torch.zeros_like(mel)], dim=1)
        scores = self.forward(rows_at(ext, scal[:, WIN_OFF], M)[:, None])
        pad = scores.new_zeros(B, 2 * M - scores.shape[1], scores.shape[2])
        out = rows_at(torch.cat([scores, pad], dim=1), scal[:, E_OFF], self.emit_max)

        # 5. shift the mel ring for the next tick.
        mel = rows_at(ext, scal[:, SHIFT], M)
        return buf, mel.contiguous(), out


class DeviceStreamingDetector:
    """B lockstep streams with their rings on ``device``."""

    def __init__(
        self,
        model: torch.nn.Module,
        cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
        batch: int = 1,
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
        """``featurizer``: 'auto', 'pallas' or 'xla' (see
        :func:`resolve_tick_featurizer`).  ``featurizer_precision``: None or
        'parity'.  ``extract_impl``: 'slices' (default) or 'span' (see
        :class:`RingTick`).  ``mesh`` and ``qparams`` are not ported and
        raise."""
        refuse_unported(qparams)
        featurizer = resolve_tick_featurizer(featurizer, cfg, mesh)
        resolve_featurizer_precision(featurizer_precision)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch = batch
        self.chunk = int(chunk_samples)
        self.halo = halo
        self.stride = total_stride
        self._model = model
        self._closed = False
        (self._frames_max, self._emit_max, self._m,
         self._l) = ring_geometry(cfg, self.chunk, halo, total_stride, bucket)
        self.mean = None if mean is None else np.asarray(mean, np.float32)
        self.std = None if std is None else np.asarray(std, np.float32)

        # Startup runs through the host class until every reflection-
        # dependent frame is featurized and the ring covers the live window.
        self._stream_fns = make_stream_fns(model, cfg, mean=self.mean,
                                           std=self.std, device=self.device,
                                           featurizer=featurizer)
        self._host = BatchedStreamingDetector(
            model, cfg, batch=batch, halo=halo, total_stride=total_stride,
            bucket=bucket, mean=mean, std=std, stream_fns=self._stream_fns)
        self._switch_after = cfg.nfft + cfg.hop_size  # total samples, then migrate
        self._device_mode = False
        self._counters = None   # schedule counters, valid in device mode
        self._buf = None        # (B, L) f32 on device
        self._mel = None        # (B, M, mel) f32 on device
        self._tick = RingTick(*self._stream_fns, cfg, self.chunk,
                              self._frames_max, self._emit_max, self._m,
                              extract_impl)

    # -- state migration -----------------------------------------------------

    def _migrate_to_device(self):
        h = self._host
        t_total = h._buf_start + h._samples.shape[1]
        self._counters = {"t_total": t_total, "n_frames": h._n_frames,
                          "emitted": h._emitted, "mel_start": h._mel_start}
        buf = np.zeros((self.batch, self._l), np.float32)
        # place host samples [buf_start, T) at ring-relative positions
        lo = t_total - self._l
        src_lo = max(h._buf_start, lo)
        buf[:, src_lo - lo:] = h._samples[:, src_lo - h._buf_start:]
        self._buf = torch.from_numpy(buf).to(self.device)

        mel = np.zeros((self.batch, self._m, self.cfg.mel_bins), np.float32)
        n = h._n_frames - h._mel_start
        mel[:, :n] = h._frames_mel[:, :n]
        self._mel = torch.from_numpy(mel).to(self.device)
        self._device_mode = True
        self._host = None

    def _migrate_to_host(self) -> BatchedStreamingDetector:
        c = self._counters
        lo = max(0, c["t_total"] - self._l)
        buf = self._buf.cpu().numpy()
        mel = self._mel.cpu().numpy()
        return BatchedStreamingDetector.from_state(
            self._model, self.cfg, batch=self.batch, halo=self.halo,
            total_stride=self.stride, bucket=self._m, mean=self.mean,
            std=self.std, samples=buf[:, lo - (c["t_total"] - self._l):],
            buf_start=lo, n_frames=c["n_frames"],
            frames_mel=mel[:, : c["n_frames"] - c["mel_start"]],
            mel_start=c["mel_start"], emitted=c["emitted"],
            stream_fns=self._stream_fns)

    # -- public API ----------------------------------------------------------

    def push(self, chunk: np.ndarray) -> np.ndarray:
        """Feed (batch, chunk_samples) int16 PCM, uint8 µ-law or float32
        audio; returns the newly finalized (batch, frames, classes) block."""
        if self._closed:
            raise RuntimeError("stream already flushed; create a new detector")
        chunk = np.asarray(chunk)
        if chunk.shape != (self.batch, self.chunk):
            raise ValueError(f"lockstep push must be {(self.batch, self.chunk)}, "
                             f"got {chunk.shape}")
        if not self._device_mode:
            out = self._host.push(ingest_to_f32_np(chunk))
            if (self._host._buf_start + self._host._samples.shape[1]
                    >= self._switch_after):
                self._migrate_to_device()
            return out

        (offs, n_new, write_pos, win_off, e_off, shift, emit_n,
         new_c) = tick_schedule(self._counters, self.chunk, self._frames_max,
                                self._emit_max, self._m, self._l, self.cfg,
                                self.stride, self.halo)
        row = schedule_row(offs, n_new, write_pos, win_off, e_off, shift)
        sched = torch.from_numpy(np.tile(row, (self.batch, 1))).to(self.device)
        if chunk.dtype not in (np.int16, np.uint8):
            chunk = chunk.astype(np.float32)
        self._buf, self._mel, out = self._tick(
            self._buf, self._mel, torch.from_numpy(chunk).to(self.device), sched)
        self._counters = new_c
        return out[:, :emit_n].cpu().numpy()

    def flush(self) -> np.ndarray:
        """End of stream: exact tail through the host flush.  Terminal:
        further push()/flush() calls raise."""
        if self._closed:
            raise RuntimeError("stream already flushed")
        self._closed = True
        if not self._device_mode:
            return self._host.flush()
        return self._migrate_to_host().flush()
