"""Streaming (online) sound-event detection (counterpart of ``sed_tpu.streaming``).

Audio arrives in chunks of any size; the detector emits per-frame scores
incrementally, equal to offline whole-recording scoring of the same audio:

  * an STFT frame t (centred at t*hop) is computable once samples up to
    t*hop + nfft/2 have arrived; the reflect padding at the stream start
    only needs *future* samples, so early frames match offline;
  * a frame's score is final once ``halo`` (>= receptive_field/2,
    stride-aligned) frames of right context exist, so scores are emitted in
    stride-aligned blocks with that latency;
  * ``flush()`` emits the exact tail using the true end boundary.

The featurizer state is a rolling raw-sample buffer on the host; the model
state a rolling log-mel buffer trimmed to the context the next emission
needs.  Frames are featurized on ``device`` through
:func:`sed_tpu_torch.ops.featurizer.logmel_frames` (K3 + K2 on CUDA) and
scored there by the model.

Two classes:
  * :class:`BatchedStreamingDetector` — N lockstep streams (every ``push``
    feeds the same number of samples to each), all device work batched;
  * :class:`StreamingDetector` — the single-stream API.

The model is a ``torch.nn.Module`` holding its weights, in the place of
``sed_tpu``'s (model, params, batch_stats) triple.  Parity: each call of
the stream functions runs in full float32 (``utils.precision.full_float32``:
cuDNN's and matmul's TF32 off for the call, the caller's settings back
after), as ``make_batch_predictor``'s does; the streaming invariant (scores
equal offline) holds only at FP32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sed_tpu_torch.configs import DEFAULT_SPECTROGRAM, SpectrogramConfig
from sed_tpu_torch.inference import resolve_device
from sed_tpu_torch.models.cnn import MobileNetV1, mobilenet_receptive_field
from sed_tpu_torch.models.quantize import qparams_to, quantized_serving_scores
from sed_tpu_torch.ops.featurizer import logmel_frames, logmel_frames_xla
from sed_tpu_torch.parallel.time_shard import receptive_field
from sed_tpu_torch.utils.precision import full_float32


def make_stream_fns(model: torch.nn.Module,
                    cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
                    mean=None, std=None, qparams=None, device="cuda",
                    featurizer: str = "auto", precision=None):
    """The ``(featurize, forward)`` pair every detector of one model and
    normalization shares (a pool passes one pair to each per-stream
    detector it builds).

    ``featurize``: (rows, nfft) frames, float32 or int16, array or tensor ->
    (rows, mel) normalized log-mel, a tensor on ``device``.
    ``forward``: (batch, 1, frames, mel) NCHW -> (batch, frames', classes)
    sigmoid scores on ``device``; with ``qparams`` (an int8 artifact of
    ``models.quantize.quantize_cnn``, ``quantize_mobilenet`` or
    ``models.qat.qat_export``, moved to ``device``) it is
    ``quantized_serving_scores``, the family read from the artifact.

    ``featurizer``: 'auto' and 'pallas' featurize through
    :func:`sed_tpu_torch.ops.featurizer.logmel_frames` (K3 + K2 on CUDA);
    'xla' through ``logmel_frames_xla`` (the windowed rFFT and the mel
    projection in PyTorch ops, no kernel of the port), chosen only by that
    explicit name.  ``precision``: the FFT's precision on the 'auto' and
    'pallas' paths (``logmel_frames``: None the parity K3, a reduced one
    K3t); 'xla' ignores it, as sed_tpu's XLA tick does.

    ``model`` is moved to ``device``.  Each call of ``forward`` puts it in
    eval mode (running BatchNorm statistics, left as they were) and leaves
    it there; both functions run in full float32 for the call.  ``forward``
    applies the sigmoid: give it a logits-emitting model (MobileNetV1 with
    ``emit='logits'``).  A bf16-tier model (``dtype=torch.bfloat16``, as
    ``sed_tpu``'s pools take a ``dtype=bfloat16`` model) computes only its
    own forward in bfloat16: the frames, the log-mel, the normalization, the
    state every detector and pool carries, and the scores stay float32.
    """
    if featurizer in ("auto", "pallas"):
        featurize_frames = lambda x: logmel_frames(x, cfg, precision)  # noqa: E731
    elif featurizer == "xla":
        featurize_frames = lambda x: logmel_frames_xla(x, cfg)  # noqa: E731
    else:
        raise ValueError(f"featurizer must be auto|xla|pallas, got {featurizer}")
    device = resolve_device(device)
    model = model.to(device)

    def as_stat(a):
        return None if a is None else torch.as_tensor(np.asarray(a, np.float32),
                                                      device=device)

    mean_t, std_t = as_stat(mean), as_stat(std)

    @torch.no_grad()
    @full_float32()
    def featurize(frames) -> torch.Tensor:
        lm = featurize_frames(torch.as_tensor(frames, device=device))
        if mean_t is not None:
            lm = (lm - mean_t) / std_t
        return lm

    if qparams is not None:
        qparams = qparams_to(qparams, device)

        def forward(x) -> torch.Tensor:
            return quantized_serving_scores(qparams, torch.as_tensor(x, device=device))
    else:
        @torch.no_grad()
        @full_float32()
        def forward(x) -> torch.Tensor:
            model.eval()
            return torch.sigmoid(model(torch.as_tensor(x, device=device)))

    return featurize, forward


def emission_upto(n_frames: int, stride: int, halo: int, final: bool) -> int:
    """Highest frame index (exclusive) whose score is final: stride-aligned,
    with ``halo`` frames of right context unless the stream ended.  The one
    definition shared by the host and device-resident detectors."""
    if final:
        return stride * (n_frames // stride)
    return stride * max(0, (n_frames - halo) // stride)


def window_start(emitted: int, stride: int, halo: int) -> int:
    """Left edge of the mel window the next emission needs (stride-aligned,
    ``halo`` frames of left context before the first unemitted frame)."""
    return max(0, stride * ((emitted - halo) // stride))


def tick_schedule(counters: dict, chunk: int, frames_max: int, emit_max: int,
                  ring_m: int, ring_l: int, cfg, stride: int, halo: int):
    """One tick's ring-relative schedule from absolute stream counters, the
    single definition shared by DeviceStreamingDetector (lockstep fleet) and
    StreamPool (per-slot lifecycle).

    ``counters``: ``{'t_total', 'n_frames', 'emitted', 'mel_start'}``.
    Returns ``(offs, n_new, write_pos, win_off, e_off, shift, emit_n,
    new_counters)`` where ``offs`` is the (frames_max,) int32 window-start
    vector into the sample ring.  Raises ValueError on any geometry
    violation: the device tick indexes the rings with these integers, and an
    index outside a ring would fault the card.

    Divergence from ``sed_tpu``: the same integer math, plus three guards on
    the window, score and ring-shift reads (``win_off <= ring_m``,
    ``shift <= ring_m``, ``e_off + emit_max <= 2 * ring_m``), which
    ``sed_tpu``'s clamping slices did not need.  They never fire in a valid
    geometry.
    """
    hop, pad = cfg.hop_size, cfg.nfft // 2
    t_total, n_frames = counters["t_total"], counters["n_frames"]
    emitted, mel_start = counters["emitted"], counters["mel_start"]

    t_new = t_total + chunk
    n_ready = max(0, (t_new - pad) // hop + 1)
    n_new = n_ready - n_frames
    if not (0 <= n_new <= frames_max):
        raise ValueError(
            f"ring geometry violated: n_new={n_new} outside [0, {frames_max}]")

    base = t_new - ring_l
    offs = np.empty(frames_max, np.int32)
    for j in range(frames_max):
        if n_new > 0:
            t = n_frames + min(j, n_new - 1)
        else:
            # masked-out dummy: the last already-featurized frame, whose
            # window is still guaranteed inside the ring
            t = n_frames - 1
        offs[j] = t * hop - pad - base
    if not ((offs >= 0).all() and (offs + cfg.nfft <= ring_l).all()):
        raise ValueError(
            f"frame window offsets {offs.min()}..{offs.max()} escape the "
            f"sample ring [0, {ring_l})")

    upto = emission_upto(n_ready, stride, halo, final=False)
    emit_n = max(0, upto - emitted)
    if emit_n > emit_max:
        raise ValueError(
            f"emission schedule violated: emit_n={emit_n} > "
            f"emit_max={emit_max}")

    s = window_start(emitted, stride, halo)
    win_off = s - mel_start
    e_off = emitted - s
    write_pos = n_frames - mel_start
    new_emitted = emitted + emit_n
    keep = window_start(new_emitted, stride, halo)
    shift = keep - mel_start
    if win_off < 0 or write_pos < 0 or shift < 0:
        raise ValueError(
            f"mel-ring schedule violated: win_off={win_off} "
            f"write_pos={write_pos} shift={shift} (all must be >= 0)")
    if write_pos + frames_max > ring_m:
        raise ValueError(
            f"mel-ring capacity exceeded: write_pos={write_pos} + "
            f"frames_max={frames_max} > ring={ring_m}")
    if win_off > ring_m or shift > ring_m or e_off + emit_max > 2 * ring_m:
        raise ValueError(
            f"ring reads escape their rings: win_off={win_off} shift={shift} "
            f"(<= {ring_m}), e_off={e_off} + emit_max={emit_max} "
            f"(<= {2 * ring_m})")

    new_counters = {"t_total": t_new, "n_frames": n_ready,
                    "emitted": new_emitted, "mel_start": keep}
    return offs, n_new, write_pos, win_off, e_off, shift, emit_n, new_counters


class BatchedStreamingDetector:
    """Online detection over ``batch`` lockstep streams.

    ``push`` takes (batch, samples) and returns the newly finalized
    (batch, frames, classes) scores as numpy.  All streams share the frame
    clock (same chunk length per push).
    """

    def __init__(
        self,
        model: torch.nn.Module,
        cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
        batch: int = 1,
        halo: int = 64,
        total_stride: int = 8,
        bucket: int = 128,
        mean: Optional[np.ndarray] = None,
        std: Optional[np.ndarray] = None,
        qparams=None,
        stream_fns=None,
        device="cuda",
    ):
        """``qparams``: an int8 serving artifact (``models.quantize`` /
        ``models.qat.qat_export``): the stream scores through the int8
        forward.  ``stream_fns``: optionally a shared ``(featurize,
        forward)`` pair from :func:`make_stream_fns`, built with the same
        model, cfg, mean, std and qparams; it decides the device, and
        ``device`` is then unused."""
        if halo % total_stride:
            raise ValueError(f"halo={halo} must be a multiple of "
                             f"total_stride={total_stride}")
        rf = None
        if hasattr(model, "model_config"):
            rf = receptive_field(model.model_config)
        elif isinstance(model, MobileNetV1):
            rf = mobilenet_receptive_field()
        if rf is not None and halo < (rf + 1) // 2:
            need = total_stride * (-(-((rf + 1) // 2) // total_stride))
            raise ValueError(
                f"halo={halo} frames is smaller than half the model's "
                f"receptive field ({rf} frames); emitted scores would be "
                f"corrupted — use halo >= {need}")
        self.model = model
        self.cfg = cfg
        self.batch = batch
        self.halo = halo
        self.stride = total_stride
        self.bucket = bucket
        self.mean = None if mean is None else np.asarray(mean, np.float32)
        self.std = None if std is None else np.asarray(std, np.float32)

        self._pad = cfg.nfft // 2
        self._samples = np.zeros((batch, 0), np.float32)  # rolling buffers
        self._buf_start = 0          # absolute index of _samples[:, 0]
        self._n_frames = 0           # frames featurized so far (per stream)
        self._frames_mel = np.zeros((batch, 0, cfg.mel_bins), np.float32)
        self._mel_start = 0          # absolute frame index of _frames_mel[:, 0]
        self._emitted = 0            # frames whose scores have been emitted

        if stream_fns is None:
            stream_fns = make_stream_fns(model, cfg, mean=self.mean, std=self.std,
                                         qparams=qparams, device=device)
        self._featurize, self._forward = stream_fns

    @classmethod
    def from_state(cls, model, cfg, *, batch, halo, total_stride, bucket,
                   mean, std, samples, buf_start, n_frames, frames_mel,
                   mel_start, emitted, qparams=None, stream_fns=None,
                   device="cuda"):
        """Rebuild a detector around externally held streaming state (the
        device-resident pipelines migrate back through this to flush)."""
        det = cls(model, cfg, batch=batch, halo=halo,
                  total_stride=total_stride, bucket=bucket, mean=mean, std=std,
                  qparams=qparams, stream_fns=stream_fns, device=device)
        det._samples = np.asarray(samples, np.float32)
        det._buf_start = int(buf_start)
        det._n_frames = int(n_frames)
        det._frames_mel = np.asarray(frames_mel, np.float32)
        det._mel_start = int(mel_start)
        det._emitted = int(emitted)
        return det

    # -- featurizer side ----------------------------------------------------

    def _frame_slice(self, t: int) -> np.ndarray:
        """Samples [t*hop - pad, t*hop - pad + nfft) with start reflection,
        per stream: (batch, nfft)."""
        cfg = self.cfg
        start = t * cfg.hop_size - self._pad
        end = start + cfg.nfft
        out = np.empty((self.batch, cfg.nfft), np.float32)
        if start < 0:
            # Reflect indices -i -> +i (numpy 'reflect': no edge repeat).
            neg = np.arange(start, 0)
            out[:, : len(neg)] = self._samples[:, (-neg) - self._buf_start]
            out[:, len(neg):] = self._samples[:, 0 - self._buf_start:end - self._buf_start]
        else:
            out[:] = self._samples[:, start - self._buf_start:end - self._buf_start]
        return out

    def _new_frames(self) -> np.ndarray:
        """Push phase 1 (host only): frame, but do not featurize, every newly
        completed frame -> (batch, k, nfft), k >= 0.  Split out so StreamPool
        can featurize every pending stream's frames in one call."""
        cfg = self.cfg
        total = self._buf_start + self._samples.shape[1]
        # Frame t needs samples through t*hop + pad.
        n_ready = max(0, (total - self._pad) // cfg.hop_size + 1)
        if n_ready <= self._n_frames:
            return np.zeros((self.batch, 0, cfg.nfft), np.float32)
        return np.stack([self._frame_slice(t)
                         for t in range(self._n_frames, n_ready)], axis=1)

    def _install_new(self, lm: np.ndarray) -> None:
        """Push phase 2: absorb featurized (batch, k, mel) frames and drop
        raw samples no longer needed (keep the reflect prefix until past
        it).  Always retain >= pad+1 tail samples so flush() can build the
        end reflection even where hop >= nfft/2."""
        cfg = self.cfg
        if lm.shape[1]:
            self._frames_mel = np.concatenate([self._frames_mel, lm], axis=1)
            self._n_frames += lm.shape[1]
        total = self._buf_start + self._samples.shape[1]
        keep_from = max(0, self._n_frames * cfg.hop_size - self._pad)
        keep_from = min(keep_from, max(0, total - (self._pad + 1)))
        if keep_from > self._buf_start:
            self._samples = self._samples[:, keep_from - self._buf_start:]
            self._buf_start = keep_from

    def _featurize_frames(self, frames: np.ndarray) -> np.ndarray:
        """Featurize (batch, k, nfft) -> (batch, k, mel) in one device call.
        (``sed_tpu`` pads the row count to a multiple of 8 to bound jit's
        compiled shapes; eager PyTorch compiles nothing, so rows go as
        they are.)"""
        b, k, nfft = frames.shape
        lm = self._featurize(torch.from_numpy(frames.reshape(b * k, nfft)))
        return lm.cpu().numpy().reshape(b, k, -1)

    # -- model side ----------------------------------------------------------

    def _emittable(self, final: bool) -> int:
        return emission_upto(self._n_frames, self.stride, self.halo, final)

    def _score(self, window: np.ndarray) -> np.ndarray:
        """(batch, frames, mel) window -> (batch, frames', classes) scores."""
        return self._forward(torch.from_numpy(window)[:, None]).cpu().numpy()

    def _run_model(self, upto: int, final: bool) -> np.ndarray:
        """Score frames [self._emitted, upto) exactly: (batch, k, classes)."""
        s = window_start(self._emitted, self.stride, self.halo)
        window = self._frames_mel[:, s - self._mel_start:self._n_frames - self._mel_start]
        n = window.shape[1]
        if not final:
            # Bucket the window length; zero padding sits beyond the trusted
            # region (>= halo past `upto`) so trimmed outputs are exact.
            padded = self.bucket * (-(-n // self.bucket))
            window = np.pad(window, ((0, 0), (0, padded - n), (0, 0)))
        scores = self._score(window)
        return scores[:, self._emitted - s:upto - s]

    def stage(self, chunk: np.ndarray) -> None:
        """Append (batch, samples) audio without featurizing or emitting, so
        a trailing remainder and the tail are scored by one :meth:`flush`."""
        chunk = np.asarray(chunk, np.float32).reshape(self.batch, -1)
        self._samples = np.concatenate([self._samples, chunk], axis=1)

    def push(self, chunk: np.ndarray) -> np.ndarray:
        """Feed (batch, samples) float32 audio; returns newly finalized
        (batch, frames, classes) scores (possibly with 0 frames)."""
        self.stage(chunk)
        new = self._new_frames()
        if new.shape[1]:
            self._install_new(self._featurize_frames(new))
        return self._emit()

    def _emit(self) -> np.ndarray:
        """Push phase 3: score and return every newly finalized frame."""
        upto = self._emittable(final=False)
        if upto <= self._emitted:
            return np.zeros((self.batch, 0, self.cfg.classes_num), np.float32)
        out = self._run_model(upto, final=False)
        self._emitted = upto
        self._trim_mel()
        return out

    def flush(self) -> np.ndarray:
        """End of stream: featurize remaining frames (end reflect padding) and
        emit the exact tail.  Split into phases (_final_frames /
        _install_final / _final_window + _final_trim) so StreamPool.leave_many
        can batch each device call across streams that drain together."""
        new = self._final_frames()
        if new.shape[1]:
            self._install_final(self._featurize_frames(new))
        fw = self._final_window()
        if fw is None:
            return np.zeros((self.batch, 0, self.cfg.classes_num), np.float32)
        window, s, upto, pad_l = fw
        return self._final_trim(self._score(window), s, upto, pad_l)

    def _final_frames(self) -> np.ndarray:
        """Flush phase 1 (host only): validate, append the end reflection,
        and frame the not-yet-featurized tail -> (batch, k, nfft), k >= 0."""
        cfg = self.cfg
        total = self._buf_start + self._samples.shape[1]
        if total <= self._pad:
            # Same constraint as the offline reflect-padded STFT: the recording
            # must be longer than nfft/2 samples for centre padding to exist.
            raise ValueError(
                f"stream too short to featurize: {total} samples <= reflect "
                f"padding {self._pad} (need > {self._pad} samples, i.e. "
                f"{self._pad / cfg.working_sample_rate:.2f} s at "
                f"{cfg.working_sample_rate} Hz)"
            )
        n_total_frames = 1 + (total // cfg.hop_size)
        # Append the end reflection so trailing frames can be featurized.
        if self._samples.shape[1] > 1:
            tail_pad = np.flip(self._samples[:, -self._pad - 1:-1], axis=1)
        else:
            tail_pad = np.zeros((self.batch, self._pad), np.float32)
        self._samples = np.concatenate([self._samples, tail_pad], axis=1)
        if n_total_frames <= self._n_frames:
            return np.zeros((self.batch, 0, cfg.nfft), np.float32)
        return np.stack([self._frame_slice(t)
                         for t in range(self._n_frames, n_total_frames)],
                        axis=1)

    def _install_final(self, lm: np.ndarray) -> None:
        """Flush phase 2: absorb the featurized (batch, k, mel) tail frames."""
        if lm.shape[1]:
            self._frames_mel = np.concatenate([self._frames_mel, lm], axis=1)
            self._n_frames += lm.shape[1]

    def _final_window(self):
        """Flush phase 3a (host only): the tail mel window to score ->
        ``(window, s, upto, pad_l)`` or None when nothing is left to emit.

        The window is left-padded with zero mel frames to the bucket grid in
        multiples of the model stride (pooling phase preserved).  ``s > 0``
        implies ``emitted - s >= halo``, so the padding sits beyond the
        receptive field of every emitted score: values are unchanged, and the
        drains of a pool see a handful of window lengths."""
        upto = self._emittable(final=True)
        if upto <= self._emitted:
            return None
        s = window_start(self._emitted, self.stride, self.halo)
        window = self._frames_mel[:, s - self._mel_start:
                                  self._n_frames - self._mel_start]
        pad_l = 0
        if s > 0:
            n = window.shape[1]
            target = self.bucket * (-(-n // self.bucket))
            pad_l = ((target - n) // self.stride) * self.stride
            if pad_l:
                window = np.pad(window, ((0, 0), (pad_l, 0), (0, 0)))
        return window, s, upto, pad_l

    def _final_trim(self, scores: np.ndarray, s: int, upto: int,
                    pad_l: int) -> np.ndarray:
        """Flush phase 3b: trim the scored window to the exact emitted tail."""
        out = scores[:, pad_l + self._emitted - s:pad_l + upto - s]
        self._emitted = upto
        return out

    def _trim_mel(self) -> None:
        keep_from = window_start(self._emitted, self.stride, self.halo)
        if keep_from > self._mel_start:
            self._frames_mel = self._frames_mel[:, keep_from - self._mel_start:]
            self._mel_start = keep_from


class StreamingDetector(BatchedStreamingDetector):
    """Single-stream online detector (a 1-stream batch)."""

    def __init__(self, model: torch.nn.Module,
                 cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM, halo: int = 64,
                 total_stride: int = 8, bucket: int = 128,
                 mean: Optional[np.ndarray] = None,
                 std: Optional[np.ndarray] = None, qparams=None,
                 stream_fns=None, device="cuda"):
        super().__init__(model, cfg, batch=1, halo=halo,
                         total_stride=total_stride, bucket=bucket, mean=mean,
                         std=std, qparams=qparams, stream_fns=stream_fns,
                         device=device)

    def push(self, chunk: np.ndarray) -> np.ndarray:
        """Feed (samples,) float32 audio; returns newly finalized
        (frames, classes) scores (possibly empty)."""
        chunk = np.asarray(chunk, np.float32).reshape(-1)
        return super().push(chunk[None])[0]

    def flush(self) -> np.ndarray:
        return super().flush()[0]
