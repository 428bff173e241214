#!/usr/bin/env python3
"""On-card smoke test and first measurements of sed_tpu_torch.

Run from the repository root on a machine with one CUDA card (an H100):

    python3 chip_smoke.py

It drives the PyTorch + CUDA port only (nothing of JAX or sed_tpu) and exits
non-zero on the first failure.  Phases:

  1. card     device name, ``nvidia-smi`` name and power limit; builds the
              kernels from ``sed_tpu_torch/ops/csrc`` with nvcc and prints
              the build time and ptxas' registers, shared memory and spills;
              the lesion builds (``LESIONS``: K6's three, the drain's
              exchange of K3 and K1, K5's epilogue, K2's copies and sums)
              start beside it, one nvcc for each distinct edit;
  2. kernels  K1 and K2 against their plain versions computed in float64 on
              the card, at the batch path's shapes (16 x 60 s), and K2 on the
              batch's rows from row 1 on (off a 16-byte boundary, up to the
              allocation's end) equal to the aligned rows' result; K3 at the
              streaming tick's shape (32 slots x 5 frames = 160 rows), float32
              and int16, K2 on its 160 rows and K3 + K2 (``logmel_frames``)
              against the float64 chain;
  3. slice    ``make_batch_predictor(device="cuda")`` with
              CnnAvgPooling(TRAIN_CHANNEL_AND_POOL) on 16 x 60 s int16 clips,
              then one uint8 µ-law batch; launch counts reset just before and
              read just after; clip 0 against ``device="cpu"``;
  4. CLI      ``python -m sed_tpu_torch.cli.infer --batch`` on two WAV files;
  5. pool     ``StreamPool(device="cuda")``, 32 slots, 1 s chunks: 32 streams
              of 60 s int16 audio fed in uneven pieces through feed/tick, two
              joining late and one leaving early; launch counts reset just
              before and read just after; every stream's scores (ticks + tail)
              against ``make_batch_predictor`` on the same audio;
  6. stream   ``python -m sed_tpu_torch.cli.stream`` on three WAV files;
  7. server   ``StreamServer`` on 127.0.0.1: four pcm16 clients, then one
              µ-law client, each against offline scoring of its audio;
  8. times    CUDA-event medians of K1, K2, K3, their plain versions, a
              PyTorch yardstick for each, the featurizer, the model and the
              whole 16 x 60 s batch; K3's share of its bound and its ratio
              to ``torch.fft.rfft`` + abs^2, each also with the calls
              queued (K3 takes tens of microseconds, less than one call's
              launch latency), and K3 and K1 rebuilt without their drain's
              exchange (wrong results, timing only: what the exchange
              costs); K2 at the tick's 160 rows, one call and queued, beside
              its bound, and K2 rebuilt without its copies and without its
              sums at both row counts (its time split into copies and sums);
              a
              single-round tick and a 16-round block of the 32-slot pool,
              and the tick's device time by kernel
              (``torch.profiler``); the pool run's profile split, audio-s per
              wall-s and peak device memory;
  9. impls    every implementation name of sed_tpu's featurizer on phase 3's
              16 x 60 s batch, ingested to f32 on the card: each of
              ``logmel_waveform(impl=...)`` with launch counts reset just
              before and read just after (exactly the kernels its row of
              ``IMPL_KERNELS`` names, once each) and within 1e-4 dB of the
              float64 chain; the K4 route ``logmel_features_batch(...,
              use_pallas=True)`` likewise; K5 against K1 then K2 (equal),
              K6 against its float64 plain version, 'pack''s and 'eo''s power
              against float64; CUDA-event medians of K4–K10 through their own
              entry points, their plain versions and PyTorch yardsticks, and
              of the whole ``logmel_waveform`` for each name; K6's share of
              its bound and its ratio to ``torch.fft.fft``, K6 rebuilt
              without its loads, its exchanges or its twiddles, and K5
              without its band epilogue (wrong results, timing only: what
              each part of their time is);
 10. files    the per-file path of ``cli/infer.py`` without ``--batch``, on
              two seeded WAVs (noise with tonal bursts, 48 kHz int16): 20
              minutes (3,637 frames: four uniform windows of 1,152 frames and
              a ragged tail) and 2 minutes, with CnnAvgPooling
              (TRAIN_CHANNEL_AND_POOL), MobileNetV1 and M5, each with seeded
              weights and BatchNorm statistics: ``predict_file`` (window 1024,
              halo 64, 88 after MobileNetV1's floor) equal to the whole
              forward on the card, one K1 and one K2 launch per file (counts
              reset just before, read just after), and equal to the CPU on the
              2-minute file; ``predict_file_m5`` with both stems, the card's
              framing equal to the host's, card against CPU;
              ``make_batch_predictor`` with MobileNetV1 on phase 3's batch;
              ``python -m sed_tpu_torch.cli.infer --no_plot --arch ...`` for
              the three archs (run side by side) against the in-process
              scores; the long file's K1 rows and K2 on them, and each
              ``predict_file``'s log-mel, against float64, and the 2-minute
              file's log-mel against the CPU; per-file calls split into WAV
              read, featurizer and model inside each call (median and range),
              audio-s/s with and without the read, M5's direct stem against
              its space-to-depth stem and its frame bucket (32, 128, 256),
              MobileNetV1's batch, and peak device memory.

Then one ``{"kernels": [...]}`` JSON line (K1–K10), the ``nvidia-smi`` line,
and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import pickle
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
DEVICE = "cuda"
BATCH = 16          # clips in the scored batch (bench.py's production batch)
SECONDS = 60
POOL_SLOTS = 32     # streaming pool: slots and streams
POOL_SECONDS = 60
LATE_JOINS = {POOL_SLOTS - 2: 3, POOL_SLOTS - 1: 7}   # stream -> tick it joins
EARLY_LEAVER, EARLY_SECONDS = 5, 25.25
CLI_SECONDS = (20.0, 33.3, 45.0)                      # stream CLI files
SERVER_SECONDS = (12.0, 15.5, 9.1, 20.0)              # pcm16 clients
MULAW_SECONDS = 14.0
K1_REL_TOL = 1e-5   # K1, K3: abs error / frame peak power, against float64
DB_TOL = 1e-4       # K2, K1+K2 and K3+K2: dB, against float64
SCORE_TOL = 1e-4    # scores, against the batch path or the CPU
FILE_SECONDS = (1200.0, 120.0)  # per-file phase: the long file (card), the short one (+ CPU)
FILE_WINDOW, FILE_HALO = 1024, 64  # cli/infer.py's defaults
FILE_REPS = 5       # per-file calls timed by stage (they read the WAV)
M5_BUCKETS = [32, 128, 256]  # M5 frame buckets timed in phase 10
REPS = 20
QUEUED = 20         # calls in a row between one pair of events (time_ms's calls)

# Memory rate (B/s) and FP32 rate outside the tensor cores (FLOP/s) of the
# card, from NVIDIA's data sheets, by product name; the SXM part by default.
PEAKS = {"PCIe": (2.0e12, 51.2e12), "NVL": (3.9e12, 60.0e12)}
DEFAULT_PEAK = (3.35e12, 67.0e12)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_peaks(name: str):
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    return DEFAULT_PEAK


def smi_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    return smi.splitlines()[0]


def time_ms(torch, fn, reps: int = REPS, warmup: int = 3, calls: int = 1) -> float:
    """Median device time of one call of ``fn()`` by CUDA events around
    ``calls`` calls in a row, over ``reps`` such groups.  With one call a
    group the card waits for each launch, so a kernel of tens of
    microseconds is timed with its host launch latency; ``calls`` queued
    back to back keep the card busy and time the kernel itself."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def make_signals(torch, n, samples, sr, device, seed):
    """Noise, tones, a silent stretch and a quiet signal: float32 (n, samples)."""
    g = torch.Generator(device=device).manual_seed(seed)
    t = torch.arange(samples, device=device, dtype=torch.float64) / sr
    out = 0.3 * torch.randn(n, samples, generator=g, device=device, dtype=torch.float64)
    for i in range(n):
        out[i] += 0.5 * torch.sin(2 * np.pi * 440.0 * (i + 1) * t)
    out[0, : 10 * sr] = 0.0
    out[-1] *= 1e-3
    return out.clamp(-1, 1).float().contiguous()


def fft_ops(rows: int, m: int, win_nnz: int, unpack: bool = True) -> int:
    """FP32 operations of ``rows`` windowed n_fft = 2m real DFTs and their
    power: the m-point complex FFT, the hermitian unpack and |X|^2 (left out
    when not ``unpack``: K6 stops after the FFT), and the window product."""
    return rows * (5 * m * (m.bit_length() - 1) + (19 * m if unpack else 0) + win_nnz)


def run_cli(args, what: str) -> str:
    """Run ``python -m <args>`` from the repository root; returns stdout."""
    proc = subprocess.run([sys.executable, "-m", *map(str, args)], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
    check(proc.returncode == 0, f"{what} exit code {proc.returncode}")
    return proc.stdout


def profile_ticks(torch, fn, n: int):
    """Device time per call of ``fn`` by kernel, from ``torch.profiler`` over
    ``n`` calls: ``[(kernel name, ms per call), ...]``, largest first; empty
    when the profiler captured no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3 / n) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])


# A kernel with one part of its work removed (wrong results, timing only):
# how much of its time that part holds.  Each is featurizer.cu with one edit,
# built beside the real library and timed on the same inputs through the same
# C call as the real kernel: K3's and K1's in phase 8, K6's and K5's in phase
# 9.  name -> (C entry point, anchor, replacement).  The edit applies to the
# whole file; only the named entry point is called.
LESIONS = {
    "K6 loads": ("sed_wave_packed_fft", "  load.template fill<T, P>(v, t);",
                 "#pragma unroll\n  for (int s = 0; s < kPoints; ++s)\n"
                 "    v[s] = make_float2(t * 1e-3f + s, s * 0.5f - t);"),
    "K6 exchanges": ("sed_wave_packed_fft",
                     "      if (pass + 1 < a || r > 1) stockham_exchange<16, 1>(v, sre, sim, t, T, p);",
                     ""),
    "K6 twiddles": ("sed_wave_packed_fft",
                    "    if (p > 1) {\n      const int k = (t + b * T)",
                    "    if (false) {\n      const int k = (t + b * T)"),
    "K3 drain exchange": ("sed_frames_stft_power",
                          "    constexpr bool in_registers = T == 1;",
                          "    constexpr bool in_registers = true;"),
    "K1 drain exchange": ("sed_wave_stft_power",
                          "    constexpr bool in_registers = T == 1;",
                          "    constexpr bool in_registers = true;"),
    "K5 epilogue": ("sed_wave_stft_mel_log",
                    "  mel_log_row<kWarps>(power, seg, band_first, weights, power + m + 1, row, "
                    "n_mels, n_seg);",
                    "  (void)kWarps;"),
    "K2 copies": ("sed_mel_log", "        stage_chunk<R>(a, ring, full, g, k, seq, lane);",
                  "        mbar_arrive(full + seq % D); if (lane == 0) mbar_arrive(full + seq % D);"),
    "K2 sums": ("sed_mel_log", "        segment_sums<R>(x, w, s.y, lane, sum);",
                "        for (int r = 0; r < R; ++r) sum[r] = 0.f;"),
}
_lesion_builds = []


def start_lesions(kernels):
    """Start one nvcc per distinct edit (all at once, beside the main build);
    lesions that make the same edit share its library."""
    src = kernels.SOURCE.read_text()
    out = kernels.BUILD_DIR / "lesions"
    out.mkdir(parents=True, exist_ok=True)
    started = {}
    for name, (_, old, new) in LESIONS.items():
        check(src.count(old) == 1, f"lesion {name!r}: its anchor is in featurizer.cu")
        if (old, new) in started:
            _lesion_builds.append((name, *started[old, new]))
            continue
        stem = name.replace(" ", "_")
        cu, so, build_log = out / f"{stem}.cu", out / f"lib{stem}.so", out / f"{stem}.log"
        cu.write_text(src.replace(old, new))
        with open(build_log, "w") as f:
            proc = subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(so), str(cu)],
                                    stdout=f, stderr=subprocess.STDOUT)
        started[old, new] = (proc, so, build_log)
        _lesion_builds.append((name, proc, so, build_log))


def stop_lesions() -> None:
    for _, proc, _, _ in _lesion_builds:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def finish_lesions():
    """Wait for the lesion builds; returns {name: its C entry point}, typed
    as ``cuda_featurizer._library()`` types it."""
    import ctypes

    from sed_tpu_torch.ops import cuda_featurizer as kernels

    fns = {}
    for name, proc, so, build_log in _lesion_builds:
        proc.wait(timeout=600)
        check(proc.returncode == 0,
              f"lesion {name!r} builds: {build_log.read_text()[-2000:]}")
        entry = LESIONS[name][0]
        fn = getattr(ctypes.CDLL(str(so)), entry)
        typed = getattr(kernels._library(), entry)
        fn.argtypes, fn.restype = typed.argtypes, typed.restype
        fns[name] = fn
    return fns


def score_all(torch, predict, clips):
    """Offline scores of (samples,) int16 or uint8 clips of one length, in
    batches of up to ``BATCH``: (n, frames', classes) numpy."""
    outs = []
    for i in range(0, len(clips), BATCH):
        batch = torch.from_numpy(np.stack(clips[i:i + BATCH]))[..., None]
        outs.append(predict(batch).cpu().numpy())
    return np.concatenate(outs)


def impls_phase(torch, cfg, dev, bound, win_nnz, lesions):
    """Phase 9: every implementation name of sed_tpu's featurizer on the card
    (see the module docstring).  Returns the ``kernels`` entries of K4–K10."""
    from sed_tpu_torch.ops import cuda_featurizer as kernels
    from sed_tpu_torch.ops import stft as stft_ops
    from sed_tpu_torch.ops.featurizer import ingest_to_f32, logmel_features_batch
    from sed_tpu_torch.ops.mel import mel_filterbank

    t0 = time.perf_counter()
    sr, hop, n_fft, n_bins = cfg.working_sample_rate, cfg.hop_size, cfg.nfft, cfg.freq_bins
    m, n_mels = n_fft // 2, cfg.mel_bins
    samples = sr * SECONDS
    window = kernels.stft_window(cfg, dev)
    bands = kernels.mel_bands(cfg, dev)
    fb64 = torch.from_numpy(mel_filterbank(cfg, np.float64)).to(dev)
    # Phase 3's batch (same seed), ingested to f32 on the card.
    pcm = (make_signals(torch, BATCH, samples, sr, dev, 1) * 32767).round().to(torch.int16)
    waves = ingest_to_f32(pcm).contiguous()
    ref_power = kernels.wave_stft_power_plain(waves.double(), window, hop, n_fft)
    frames = ref_power.shape[0] * ref_power.shape[1]
    power_peak = ref_power.amax(dim=-1, keepdim=True)
    chain = kernels.mel_log_plain(ref_power.reshape(-1, n_bins), fb64).reshape(
        BATCH, -1, n_mels)

    def power_errors(power):
        err = (power.double() - ref_power).abs()
        return float(err.max()), float((err / power_peak.clamp_min(1e-30)).max())

    # Each impl name: launch counts reset just before and read just after.
    runs = {}
    for impl, names in kernels.IMPL_KERNELS.items():
        kernels.reset_launch_counts()
        out = kernels.logmel_waveform(waves, cfg, impl=impl)
        torch.cuda.synchronize()
        launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
        err = float((out.double() - chain).abs().max())
        runs[impl] = (launched, err)
        log(f"[impls] logmel_waveform(impl={impl!r}) {tuple(out.shape)}: launches "
            f"{launched}; vs float64 chain {err:.3e} dB (tol {DB_TOL})")
        check(out.shape == chain.shape, f"impl {impl} shape {tuple(out.shape)}")
        check(launched == dict.fromkeys(names, 1), f"impl {impl} launched {names} once each")
        check(err <= DB_TOL, f"impl {impl} within 1e-4 dB of the float64 chain")
    # K4's route: the STFT in PyTorch, then the mel kernel.
    kernels.reset_launch_counts()
    route = logmel_features_batch(pcm[..., None], cfg, use_pallas=True)
    torch.cuda.synchronize()
    k4_launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
    k4_route_err = float((route[:, 0].double() - chain).abs().max())
    log(f"[impls] logmel_features_batch(use_pallas=True) {tuple(route.shape)}: "
        f"launches {k4_launched}; vs float64 chain {k4_route_err:.3e} dB (tol {DB_TOL})")
    check(k4_launched == {"mel_log": 1}, "the use_pallas=True route launched K4 only")
    check(k4_route_err <= DB_TOL, "use_pallas=True within 1e-4 dB of the float64 chain")
    del route

    # K4 alone on that route's power, against its plain version in float64.
    re, im = stft_ops.stft_realimag(waves, cfg, "fft")
    k4_power = (re * re + im * im).contiguous()
    del re, im
    k4_out = kernels.power_to_logmel_cuda(k4_power, cfg)
    k4_err = float((k4_out.double() - kernels.mel_log_plain(
        k4_power.double().reshape(-1, n_bins), fb64).reshape(k4_out.shape)).abs().max())
    log(f"[kernels] K4 power_to_logmel_cuda (mel_log) {tuple(k4_out.shape)}: max err "
        f"{k4_err:.3e} dB against float64 (tol {DB_TOL})")
    check(k4_err <= DB_TOL, "K4 within 1e-4 dB of float64")

    # K5 against K1 then K2, and against float64.
    fused = kernels.wave_stft_mel_log(waves, window, hop, n_fft, bands)
    k1_power = kernels.wave_stft_power(waves, window, hop, n_fft)
    two = kernels.mel_log(k1_power.reshape(-1, n_bins), bands).reshape(fused.shape)
    torch.cuda.synchronize()
    k5_vs_two = float((fused - two).abs().max())
    k5_err = float((fused.double() - chain).abs().max())
    log(f"[kernels] K5 wave_stft_mel_log {tuple(fused.shape)}: vs K1 then K2 "
        f"{k5_vs_two:.3e} dB (0 expected, tol 1e-5), {int((fused != two).sum())} "
        f"values differ; vs float64 chain {k5_err:.3e} dB (tol {DB_TOL})")
    check(k5_vs_two <= 1e-5, "K5 equals K1 then K2 within 1e-5 dB")
    check(k5_err <= DB_TOL, "K5 within 1e-4 dB of the float64 chain")
    del fused, two

    # K6 against its plain version in float64; 'pack''s power against K1's.
    zr, zi = kernels.wave_packed_fft(waves, window, hop, n_fft)
    wr, wi = kernels.wave_packed_fft_plain(waves.double(), window, hop, n_fft)
    z_peak = torch.hypot(wr, wi).amax(dim=-1, keepdim=True).clamp_min(1e-30)
    k6_abs, k6_rel = 0.0, 0.0
    for got, want in ((zr, wr), (zi, wi)):
        err = (got.double() - want).abs()
        k6_abs = max(k6_abs, float(err.max()))
        k6_rel = max(k6_rel, float((err / z_peak).max()))
    del wr, wi, z_peak, err
    log(f"[kernels] K6 wave_packed_fft 2 x {tuple(zr.shape)}: max abs err {k6_abs:.3e}, "
        f"max err / frame peak |Z| {k6_rel:.3e} (tol {K1_REL_TOL})")
    check(k6_rel <= K1_REL_TOL, "K6 within 1e-5 x frame peak of float64")
    pack_power = kernels.packed_power_onesided(zr, zi, n_fft)
    pack_vs_k1 = float(((pack_power - k1_power).abs()
                        / k1_power.amax(dim=-1, keepdim=True).clamp_min(1e-30)).max())
    _, pack_rel = power_errors(pack_power)
    log(f"[kernels] 'pack' power (K6 + unpack) vs K1 power: {pack_vs_k1:.3e}, vs "
        f"float64 {pack_rel:.3e} of the frame peak (tol {K1_REL_TOL})")
    check(pack_rel <= K1_REL_TOL, "'pack' power within 1e-5 x frame peak of float64")
    del pack_power

    # K7, K8, K10 (K1 under their own names): power against float64.
    k1_named = {}
    for tag, fn in (("K7 eo", lambda: kernels.stft_eo_power_from_waveform(waves, cfg)),
                    ("K8 rollraw", lambda: kernels.stft_power_from_waveform_raw(waves, cfg)),
                    ("K10 slice", lambda: kernels.stft_power_from_waveform(
                        waves, cfg, impl="slice"))):
        k1_named[tag] = power_errors(fn())
        log(f"[kernels] {tag} (wave_stft_power): max abs err {k1_named[tag][0]:.3e}, "
            f"max err / frame peak {k1_named[tag][1]:.3e} (tol {K1_REL_TOL})")
        check(k1_named[tag][1] <= K1_REL_TOL, f"{tag} within 1e-5 x frame peak")
    del ref_power, power_peak
    log(f"[impls] checks {time.perf_counter() - t0:.1f} s")

    # Times.
    t0 = time.perf_counter()
    rows = k1_power.reshape(-1, n_bins)
    windowed = stft_ops.frame_signal(waves, n_fft, hop) * window
    packed = torch.complex(windowed[..., 0::2].contiguous(), windowed[..., 1::2].contiguous())
    del windowed
    ms = {
        "k4": time_ms(torch, lambda: kernels.power_to_logmel_cuda(k1_power, cfg)),
        "k4_plain": time_ms(torch, lambda: kernels.mel_log_plain(rows, bands.dense)),
        "k4_lib": time_ms(torch, lambda: 10.0 * torch.log10(
            torch.clamp(torch.matmul(rows, bands.dense), min=1e-10))),
        "k5": time_ms(torch, lambda: kernels.wave_stft_mel_log(waves, window, hop, n_fft,
                                                               bands)),
        "k5_plain": time_ms(torch, lambda: kernels.wave_stft_mel_log_plain(
            waves, window, hop, n_fft, bands.dense)),
        "k1k2": time_ms(torch, lambda: kernels.mel_log(kernels.wave_stft_power(
            waves, window, hop, n_fft).reshape(-1, n_bins), bands)),
        "stft_mel_lib": time_ms(torch, lambda: 10.0 * torch.log10(torch.clamp(
            torch.matmul(torch.stft(waves, n_fft, hop, window=window, center=True,
                                    pad_mode="reflect", return_complex=True
                                    ).abs().square().transpose(1, 2), bands.dense),
            min=1e-10))),
        "k6": time_ms(torch, lambda: kernels.wave_packed_fft(waves, window, hop, n_fft)),
        "k6_plain": time_ms(torch, lambda: kernels.wave_packed_fft_plain(
            waves, window, hop, n_fft)),
        "k6_lib": time_ms(torch, lambda: torch.fft.fft(packed, dim=-1)),
        "k7": time_ms(torch, lambda: kernels.stft_eo_power_from_waveform(waves, cfg)),
        "k8": time_ms(torch, lambda: kernels.stft_power_from_waveform_raw(waves, cfg)),
        "k9": time_ms(torch, lambda: kernels.logmel_waveform_rolledge(waves, cfg)),
        "k10": time_ms(torch, lambda: kernels.stft_power_from_waveform(
            waves, cfg, impl="slice")),
        "k1_plain": time_ms(torch, lambda: kernels.wave_stft_power_plain(
            waves, window, hop, n_fft)),
        "stft_lib": time_ms(torch, lambda: torch.stft(
            waves, n_fft, hop, window=window, center=True, pad_mode="reflect",
            return_complex=True).abs() ** 2),
    }
    del packed
    # K6 without its loads, exchanges or twiddles (wrong results): each part's share.
    zr, zi = kernels.wave_packed_fft(waves, window, hop, n_fft)
    tw = kernels._stockham_twiddles(n_fft, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def lesion_run(fn):
        err = fn(waves.data_ptr(), window.data_ptr(), tw.data_ptr(), zr.data_ptr(),
                 zi.data_ptr(), BATCH, samples, zr.shape[1], hop, n_fft.bit_length() - 2,
                 dev.index, stream)
        check(err == 0, f"K6 lesion launch ({err})")

    lesion_ms = {name[3:]: time_ms(torch, lambda fn=fn: lesion_run(fn))
                 for name, fn in lesions.items() if name.startswith("K6 ")}
    ms["k6_again"] = time_ms(torch, lambda: lesion_run(kernels._library().sed_wave_packed_fft))
    del zr, zi
    # K5 without its band epilogue (wrong results): what the epilogue costs.
    k5_out = kernels.wave_stft_mel_log(waves, window, hop, n_fft, bands)
    unpack = kernels._twiddles(n_fft, dev)

    def k5_raw_run(fn):
        err = fn(waves.data_ptr(), window.data_ptr(), tw.data_ptr(), unpack.data_ptr(),
                 bands.segments.data_ptr(), bands.band_first.data_ptr(),
                 bands.weights.data_ptr(), k5_out.data_ptr(), BATCH, samples,
                 k5_out.shape[1], hop, n_fft.bit_length() - 2, n_mels, bands.n_segments,
                 dev.index, stream)
        check(err == 0, f"K5 raw launch ({err})")

    ms["k5_no_epilogue"] = time_ms(torch, lambda: k5_raw_run(lesions["K5 epilogue"]))
    ms["k5_again"] = time_ms(torch, lambda: k5_raw_run(kernels._library().sed_wave_stft_mel_log))
    del k5_out
    impl_ms = {impl: time_ms(torch, lambda impl=impl: kernels.logmel_waveform(
        waves, cfg, impl=impl)) for impl in kernels.IMPL_KERNELS}

    nnz = bands.nnz
    # The window and the twiddles: K6 reads the pass-ordered table, K1 and
    # K5 the W_N^k table too.
    fixed = 4 * (n_fft + 2 * m)
    fixed_power = fixed + 4 * 2 * m
    wave_b = 4 * waves.numel()
    mel_b = 4 * (frames * n_mels + nnz + 5 * bands.n_segments + n_mels + 1)
    k4_bound = bound(4 * rows.numel() + mel_b, 2 * nnz * frames)
    k5_bound = bound(wave_b + fixed_power + mel_b,
                     fft_ops(frames, m, win_nnz) + 2 * nnz * frames)
    k6_bound = bound(wave_b + fixed + 2 * 4 * frames * m,
                     fft_ops(frames, m, win_nnz, unpack=False))
    k1_bound = bound(wave_b + fixed_power + 4 * rows.numel(), fft_ops(frames, m, win_nnz))
    log(f"[times] impls, {BATCH} x {SECONDS} s, {frames} frames (CUDA-event median "
        f"of {REPS}):")
    log(f"[times] K4 power_to_logmel_cuda (mel_log) {ms['k4']:.4f} ms | plain "
        f"{ms['k4_plain']:.4f} ms | matmul+log10 {ms['k4_lib']:.4f} ms | bound "
        f"{k4_bound[0]:.4f} ms ({k4_bound[1]})")
    log(f"[times] K5 wave_stft_mel_log {ms['k5']:.4f} ms | plain {ms['k5_plain']:.4f} ms "
        f"| K1 then K2 {ms['k1k2']:.4f} ms | torch.stft+abs^2+matmul+log10 "
        f"{ms['stft_mel_lib']:.4f} ms | bound {k5_bound[0]:.4f} ms ({k5_bound[1]}) | bound "
        f"share {k5_bound[0] / ms['k5']:.1%} | K5 / torch.stft chain "
        f"{ms['k5'] / ms['stft_mel_lib']:.3f}")
    log(f"[times] K5 without its band epilogue (wrong results, timing only) "
        f"{ms['k5_no_epilogue']:.4f} ms; K5 through the same C call {ms['k5_again']:.4f} ms "
        f"(the epilogue's share {ms['k5_again'] - ms['k5_no_epilogue']:.4f} ms)")
    log(f"[times] K6 wave_packed_fft {ms['k6']:.4f} ms | plain {ms['k6_plain']:.4f} ms | "
        f"torch.fft.fft of the packed frames {ms['k6_lib']:.4f} ms | bound "
        f"{k6_bound[0]:.4f} ms ({k6_bound[1]}) | bound share {k6_bound[0] / ms['k6']:.1%} "
        f"| K6 / torch.fft.fft {ms['k6'] / ms['k6_lib']:.3f}")
    log(f"[times] K6 with a part of its work removed (wrong results, timing only; K6 "
        f"timed again beside them through the same C call {ms['k6_again']:.4f} ms): " + ", ".join(
            f"without {name} {t:.4f} ms (their share {ms['k6_again'] - t:.4f} ms)"
            for name, t in lesion_ms.items()))
    log(f"[times] K1 under sed_tpu's names: K7 eo {ms['k7']:.4f} ms | K8 rollraw "
        f"{ms['k8']:.4f} ms | K10 slice {ms['k10']:.4f} ms | plain {ms['k1_plain']:.4f} ms "
        f"| torch.stft+abs^2 {ms['stft_lib']:.4f} ms | bound {k1_bound[0]:.4f} ms "
        f"({k1_bound[1]}) | K7 / torch.stft+abs^2 {ms['k7'] / ms['stft_lib']:.3f}")
    log(f"[times] K9 rolledge (K1 then K2) {ms['k9']:.4f} ms | bound {k5_bound[0]:.4f} ms")
    log("[times] logmel_waveform by impl: " + ", ".join(
        f"{impl} {t:.4f} ms" for impl, t in impl_ms.items()))
    log(f"[impls] times {time.perf_counter() - t0:.1f} s")

    source = "sed_tpu_torch/ops/csrc/featurizer.cu"
    replaces = "sed_tpu/ops/pallas_featurizer.py:"

    def entry(name, kernel, line, launches, err, t, plain, bnd, lib):
        return {"name": name, "kernel": kernel, "route": "cuda", "source": source,
                "replaces": replaces + str(line), "launches": launches,
                "max_abs_err": err, "ms": t, "plain_ms": plain, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": lib}

    def launched(*impls, kernel):
        return sum(runs[i][0].get(kernel, 0) for i in impls)

    return [
        entry("power_to_logmel_cuda", "mel_log_kernel<R>", 38, k4_launched["mel_log"], k4_err,
              ms["k4"], ms["k4_plain"], k4_bound, ms["k4_lib"]),
        entry("wave_stft_mel_log",
              "wave_stft_mel_log_kernel<LOG2_M> (stockham_fft, PowerStore, mel_log_row)", 550,
              launched("fuse", kernel="wave_stft_mel_log"), k5_err, ms["k5"],
              ms["k5_plain"], k5_bound, ms["stft_mel_lib"]),
        entry("wave_packed_fft", "wave_packed_fft", 882,
              launched("pack", kernel="wave_packed_fft"), k6_abs, ms["k6"],
              ms["k6_plain"], k6_bound, ms["k6_lib"]),
        entry("stft_eo_power_from_waveform", "wave_stft_power", 748,
              launched("eo", kernel="wave_stft_power"), k1_named["K7 eo"][0], ms["k7"],
              ms["k1_plain"], k1_bound, ms["stft_lib"]),
        entry("stft_power_from_waveform_raw", "wave_stft_power", 1156,
              launched("rollraw", kernel="wave_stft_power"), k1_named["K8 rollraw"][0],
              ms["k8"], ms["k1_plain"], k1_bound, ms["stft_lib"]),
        entry("logmel_waveform_rolledge", "wave_stft_power + mel_log", 1321,
              launched("rolledge", kernel="wave_stft_power")
              + launched("rolledge", kernel="mel_log"), runs["rolledge"][1], ms["k9"],
              ms["k5_plain"], k5_bound, ms["stft_mel_lib"]),
        entry("stft_power_from_waveform(slice, roll_nodb)", "wave_stft_power", 352,
              launched("slice", "roll_nodb", kernel="wave_stft_power"),
              k1_named["K10 slice"][0], ms["k10"], ms["k1_plain"], k1_bound,
              ms["stft_lib"]),
    ]


def seed_batch_norms(torch, model, seed):
    """Seeded, non-trivial BatchNorm statistics, scales and biases."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                m.running_mean.uniform_(-0.5, 0.5, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.uniform_(-0.3, 0.3, generator=g)
    return model.eval()


def burst_wav(path, seconds, sr, seed):
    """Noise with tonal bursts (a 2 kHz tone on for 4 s of every 20 s, a
    sweeping one for 1 s of every 7 s), 48 kHz mono int16."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr), dtype=np.float64) / sr
    x = 0.1 * rng.standard_normal(t.size)
    x += 0.5 * ((t % 20.0) < 4.0) * np.sin(2 * np.pi * 2000.0 * t)
    x += 0.4 * ((t % 7.0) < 1.0) * np.sin(2 * np.pi * (300.0 + 50.0 * (t % 7.0)) * t)
    wavfile.write(path, sr, (np.clip(x, -1, 1) * 32767).astype(np.int16))
    return path


def files_phase(torch, cfg, dev, smi, tmp):
    """Phase 10: the per-file path of ``cli/infer.py`` without ``--batch``
    (see the module docstring).  Returns the K1 and K2 launches of the two
    spectrogram ``predict_file`` runs on the long file."""
    from sed_tpu_torch.cli import infer
    from sed_tpu_torch.configs import WaveformConfig
    from sed_tpu_torch.inference import emits_scores, make_batch_predictor
    from sed_tpu_torch.io.audio import read_multichannel_audio
    from sed_tpu_torch.models.cnn import TRAIN_CHANNEL_AND_POOL, CnnAvgPooling, MobileNetV1
    from sed_tpu_torch.models.m5 import M5
    from sed_tpu_torch.ops import cuda_featurizer as kernels
    from sed_tpu_torch.ops.featurizer import logmel_features
    from sed_tpu_torch.ops.mel import mel_filterbank

    t0 = time.perf_counter()
    sr = cfg.working_sample_rate
    hop, n_fft = cfg.hop_size, cfg.nfft
    wcfg = WaveformConfig()
    long_s, short_s = FILE_SECONDS
    long_wav = str(burst_wav(tmp / "long.wav", long_s, sr, 10))
    short_wav = str(burst_wav(tmp / "short.wav", short_s, sr, 11))
    models = {
        "CnnAvgPooling": CnnAvgPooling(cfg.classes_num, TRAIN_CHANNEL_AND_POOL,
                                       generator=torch.Generator().manual_seed(10)),
        "MobileNetV1": MobileNetV1(cfg.classes_num, generator=torch.Generator().manual_seed(11)),
        "M5": M5(cfg.classes_num, generator=torch.Generator().manual_seed(12)),
    }
    for i, model in enumerate(models.values()):
        seed_batch_norms(torch, model, 20 + i)
    cpu_models = {arch: copy.deepcopy(m) for arch, m in models.items()}
    for model in models.values():
        model.to(dev)
    # Per-mel-bin normalization from the long file's own log-mel, as
    # preprocessing computes it from training features.
    wav_long = read_multichannel_audio(long_wav, target_fs=sr, cfg=cfg).astype(np.float32)
    with torch.inference_mode():
        feats = logmel_features(torch.from_numpy(wav_long).to(dev), cfg)
    mean = feats.mean(dim=(0, 1)).cpu().numpy()
    std = feats.std(dim=(0, 1)).cpu().numpy()
    del feats
    with open(tmp / "files_mean_std.pkl", "wb") as f:
        pickle.dump({"mean": mean, "std": std}, f)
    frames_long = 1 + wav_long.shape[0] // cfg.hop_size
    log(f"[files] {long_s:.0f} s and {short_s:.0f} s WAVs written ({frames_long} frames in "
        f"the long one); {time.perf_counter() - t0:.1f} s")

    # K1 and K2 at the long file's shape, one signal of 3,637 rows, against
    # float64: the log-mel of each predict_file below is held against the
    # float64 chain too.
    wave_dev = torch.from_numpy(wav_long).to(dev)
    window = kernels.stft_window(cfg, dev)
    fb64 = torch.from_numpy(mel_filterbank(cfg, np.float64)).to(dev)
    wave64 = wave_dev.T.double()
    ref_power = kernels.wave_stft_power_plain(wave64, window, hop, n_fft)[0]
    power = kernels.wave_stft_power(wave_dev.T.contiguous(), window, hop, n_fft)[0]
    check(power.shape == ref_power.shape == (frames_long, n_fft // 2 + 1),
          f"K1 on the long file {tuple(power.shape)}")
    k1_rel = float(((power.double() - ref_power).abs()
                    / ref_power.amax(dim=-1, keepdim=True).clamp_min(1e-30)).max())
    mel = kernels.mel_log(power, kernels.mel_bands(cfg, dev))
    k2_err = float((mel.double() - kernels.mel_log_plain(power.double(), fb64)).abs().max())
    ref_mel = kernels.mel_log_plain(ref_power, fb64)
    del ref_power, power, mel, wave64
    log(f"[files] K1 on the long file ({frames_long} rows of one signal): max err / frame "
        f"peak {k1_rel:.3e} (tol {K1_REL_TOL}); K2 on its rows vs float64 {k2_err:.3e} dB "
        f"(tol {DB_TOL})")
    check(k1_rel <= K1_REL_TOL, "K1 on the long file within 1e-5 x frame peak of float64")
    check(k2_err <= DB_TOL, "K2 on the long file within 1e-4 dB of float64")

    # The spectrogram archs: windowed == whole forward, one K1 + K2 a file.
    scores, file_launches, peak_mib, halos = {}, {}, {}, {}
    for arch in ("CnnAvgPooling", "MobileNetV1"):
        model = models[arch]
        halo = halos[arch] = infer.halo_floor(model, FILE_HALO)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        kernels.reset_launch_counts()
        log_mel, got = infer.predict_file(model, long_wav, cfg, mean, std, window=FILE_WINDOW,
                                          halo=FILE_HALO, device=DEVICE)
        torch.cuda.synchronize()
        launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
        peak_mib[arch] = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
        file_launches[arch] = launched
        with torch.inference_mode():
            norm = (log_mel - torch.from_numpy(mean).to(dev)) / torch.from_numpy(std).to(dev)
            whole = model(norm[None])[0]
            whole = whole if emits_scores(model) else torch.sigmoid(whole)
        whole = whole.cpu().numpy()
        mel_err = float((log_mel[0].double() - ref_mel).abs().max())
        log(f"[files] {arch} predict_file's log-mel {tuple(log_mel.shape)} vs the float64 "
            f"chain {mel_err:.3e} dB (tol {DB_TOL})")
        check(log_mel.shape == (1,) + tuple(ref_mel.shape) and mel_err <= DB_TOL,
              f"{arch} predict_file's log-mel within 1e-4 dB of the float64 chain")
        check(got.shape == whole.shape == (8 * (frames_long // 8), cfg.classes_num),
              f"{arch} windowed frames {got.shape} == whole {whole.shape}")
        check(bool(np.isfinite(got).all()), f"{arch} scores finite")
        err = float(np.abs(got - whole).max())
        log(f"[files] {arch} predict_file on the long file, window {FILE_WINDOW}, halo "
            f"{FILE_HALO} ({halo} after the floor): {got.shape[0]} frames, scores min "
            f"{got.min():.6f} max {got.max():.6f} std {got.std():.6f}; launches {launched}; "
            f"vs the whole forward on the card {err:.3e} (tol {SCORE_TOL})")
        check(launched == {"wave_stft_power": 1, "mel_log": 1},
              f"{arch} predict_file launched one K1 and one K2")
        check(err <= SCORE_TOL, f"{arch} windowed scores equal the whole forward")
        short_mel, short = infer.predict_file(model, short_wav, cfg, mean, std,
                                              window=FILE_WINDOW, halo=halo, device=DEVICE)
        short_mel_cpu, short_cpu = infer.predict_file(cpu_models[arch], short_wav, cfg, mean,
                                                      std, window=FILE_WINDOW, halo=halo,
                                                      device="cpu")
        cpu_err = float(np.abs(short - short_cpu).max())
        cpu_mel_err = float((short_mel.cpu() - short_mel_cpu).abs().max())
        log(f"[files] {arch} on the short file, card vs CPU: log-mel {cpu_mel_err:.3e} dB "
            f"(tol {DB_TOL}), scores {cpu_err:.3e} (tol {SCORE_TOL})")
        check(short_mel.shape == short_mel_cpu.shape and cpu_mel_err <= DB_TOL,
              f"{arch} log-mel on the card matches the CPU")
        check(short.shape == short_cpu.shape and cpu_err <= SCORE_TOL,
              f"{arch} card matches the CPU")
        scores[arch] = (got, short)

    # M5: both stems on the long file, the card's framing, card vs CPU.
    m5 = models["M5"]
    m5_s2d = M5(cfg.classes_num, conv1_s2d=True)
    m5_s2d.load_state_dict(m5.state_dict(), strict=True)
    m5_s2d = m5_s2d.to(dev).eval()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    got = infer.predict_file_m5(m5, long_wav, wcfg, device=DEVICE)
    peak_mib["M5"] = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
    got_s2d = infer.predict_file_m5(m5_s2d, long_wav, wcfg, device=DEVICE)
    n_m5 = (wav_long.shape[0] - wcfg.frame_size) // wcfg.hop_size + 1
    stem_err = float(np.abs(got - got_s2d).max())
    log(f"[files] M5 predict_file_m5 on the long file: {got.shape[0]} frames, scores min "
        f"{got.min():.6f} max {got.max():.6f} std {got.std():.6f}; direct vs "
        f"space-to-depth stem {stem_err:.3e} (tol {SCORE_TOL})")
    check(got.shape == got_s2d.shape == (n_m5, cfg.classes_num), f"M5 frames {got.shape}")
    check(stem_err <= SCORE_TOL, "M5's two stems agree")
    framed = infer.hop_frames(wave_dev, wcfg)
    host = torch.from_numpy(wav_long[:, 0]).unfold(0, wcfg.frame_size, wcfg.hop_size)
    check(framed.shape == (n_m5, 1, wcfg.frame_size) and torch.equal(framed[:, 0].cpu(), host),
          "M5's framing on the card equals unfold on the host")
    del framed, host
    short = infer.predict_file_m5(m5, short_wav, wcfg, device=DEVICE)
    short_cpu = infer.predict_file_m5(cpu_models["M5"], short_wav, wcfg, device="cpu")
    cpu_err = float(np.abs(short - short_cpu).max())
    log(f"[files] M5 framing on the card equals the host's; on the short file, card vs "
        f"CPU: {cpu_err:.3e} (tol {SCORE_TOL})")
    check(short.shape == short_cpu.shape and cpu_err <= SCORE_TOL, "M5 card matches the CPU")
    scores["M5"] = (got, short)

    # MobileNetV1 on phase 3's batch.
    samples = sr * SECONDS
    pcm = (make_signals(torch, BATCH, samples, sr, dev, 1)
           * 32767).round().to(torch.int16)[..., None]
    predict_mn = make_batch_predictor(models["MobileNetV1"], cfg, mean=mean, std=std,
                                      device=DEVICE)
    kernels.reset_launch_counts()
    mn_batch = predict_mn(pcm)
    torch.cuda.synchronize()
    mn_launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
    mn_cpu = make_batch_predictor(cpu_models["MobileNetV1"], cfg, mean=mean, std=std,
                                  device="cpu")(pcm[:1].cpu())
    mn_err = float((mn_batch[:1].cpu() - mn_cpu).abs().max())
    log(f"[files] MobileNetV1 make_batch_predictor on {BATCH} x {SECONDS} s: "
        f"{tuple(mn_batch.shape)}, min {float(mn_batch.min()):.6f} max "
        f"{float(mn_batch.max()):.6f}; launches {mn_launched}; clip 0 vs CPU {mn_err:.3e} "
        f"(tol {SCORE_TOL})")
    check(mn_launched == {"wave_stft_power": 1, "mel_log": 1},
          "MobileNetV1's batch launched one K1 and one K2")
    check(bool(((mn_batch >= 0) & (mn_batch <= 1)).all()), "MobileNetV1 batch scores in [0, 1]")
    check(mn_err <= SCORE_TOL, "MobileNetV1 clip 0 matches the CPU")
    log(f"[files] checks {time.perf_counter() - t0:.1f} s")

    # The CLI without --batch, the three archs side by side.
    t1 = time.perf_counter()
    procs = {}
    for arch, model in models.items():
        torch.save({"iterations": 0, "model": model.state_dict(), "optimizer": {}},
                   tmp / f"{arch}.pth")
        out = tmp / f"out_{arch}"
        args = ["sed_tpu_torch.cli.infer", "--no_plot", "--arch", arch, "--ckpt",
                tmp / f"{arch}.pth", "--device", DEVICE, "--outputs_dir", out]
        if arch != "M5":
            args += ["--mean_std_file", tmp / "files_mean_std.pkl"]
        procs[arch] = (out, subprocess.Popen(
            [sys.executable, "-m", *map(str, args), long_wav, short_wav], cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    cli_err = {}
    for arch, (out, proc) in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        if proc.returncode != 0:
            print(stdout[-4000:], stderr[-4000:], file=sys.stderr)
        check(proc.returncode == 0, f"cli.infer --arch {arch} exit code {proc.returncode}")
        err = 0.0
        for path, want in zip((long_wav, short_wav), scores[arch]):
            got = np.load(out / f"{Path(path).stem}_scores.npy")
            check(got.shape == want.shape, f"cli.infer --arch {arch} shape {got.shape}")
            err = max(err, float(np.abs(got - want).max()))
        cli_err[arch] = err
        check(err <= SCORE_TOL, f"cli.infer --arch {arch} scores match predict_file")
    log(f"[files] python -m sed_tpu_torch.cli.infer --no_plot --arch ..., both files: max "
        f"diff vs the in-process scores " + ", ".join(f"{a} {e:.3e}" for a, e in cli_err.items())
        + f" (tol {SCORE_TOL}); {time.perf_counter() - t1:.1f} s")

    # Times: per-file calls on the long file, each split into its stages
    # inside the same call (the device synchronized at each stage's end).
    t1 = time.perf_counter()

    def staged(call):
        """{stage: [ms]} of FILE_REPS calls after one warm-up, with the whole
        call ("file") and the call without the read as the stages' sums."""
        runs = {}
        for rep in range(FILE_REPS + 1):
            timings = {}
            torch.cuda.synchronize()
            call(timings)
            for stage, sec in timings.items():
                if rep:
                    runs.setdefault(stage, []).append(sec * 1e3)
        runs["no_read"] = [f + m for f, m in zip(runs["featurizer"], runs["model"])]
        runs["file"] = [r + n for r, n in zip(runs["read"], runs["no_read"])]
        return runs

    ms = {arch: staged(lambda timings, model=models[arch], halo=halos[arch]: infer.predict_file(
        model, long_wav, cfg, mean, std, FILE_WINDOW, halo, device=DEVICE, timings=timings))
        for arch in ("CnnAvgPooling", "MobileNetV1")}
    ms["M5"] = staged(lambda timings: infer.predict_file_m5(m5, long_wav, wcfg, device=DEVICE,
                                                            timings=timings))
    # M5's stems in turns: direct, s2d, s2d, direct (model only, long file).
    stem_ms = {"direct": [], "s2d": []}
    for stem in ("direct", "s2d", "s2d", "direct"):
        net = m5 if stem == "direct" else m5_s2d
        stem_ms[stem].append(time_ms(torch, lambda net=net: infer.score_frames_m5(
            net, infer.hop_frames(wave_dev, wcfg))))
    # M5's frame bucket in turns, up and down (direct stem, model only).
    bucket_ms = {b: [] for b in M5_BUCKETS}
    for b in M5_BUCKETS + M5_BUCKETS[::-1]:
        bucket_ms[b].append(time_ms(torch, lambda b=b: infer.score_frames_m5(
            m5, infer.hop_frames(wave_dev, wcfg), b), reps=REPS // 2))
    mn_batch_ms = time_ms(torch, lambda: predict_mn(pcm))

    def spread(xs):
        return f"{statistics.median(xs):.4f} ms [{min(xs):.4f}, {max(xs):.4f}]"

    log(f"[times] {smi}; per-file calls on the {long_s:.0f} s file ({frames_long} frames; M5 "
        f"{n_m5} frames): median [min, max] of {FILE_REPS} calls after one warm-up, each call "
        f"split into its stages (perf_counter, the device synchronized at each stage's end)")
    for arch in models:
        t = ms[arch]
        what = ("float32 cast on the host, upload, hop framing" if arch == "M5"
                else "float32 cast on the host, upload, K1 + K2, normalization")
        file_s, no_read_s = statistics.median(t["file"]), statistics.median(t["no_read"])
        log(f"[times] {arch}: WAV read (scipy decode, float64, mono) {spread(t['read'])} | "
            f"featurizer ({what}) {spread(t['featurizer'])} | model (+ sigmoid + scores to the "
            f"host) {spread(t['model'])} | per file {spread(t['file'])} "
            f"({long_s / file_s * 1e3:.1f} audio-s/s) | without the read {spread(t['no_read'])} "
            f"({long_s / no_read_s * 1e3:.1f} audio-s/s) | peak device memory "
            f"{peak_mib[arch]:.1f} MiB above what was allocated before the call")
    log(f"[times] M5 stem A/B (model only, {n_m5} frames in buckets of 32, CUDA-event medians "
        f"of {REPS}, in turns direct, s2d, s2d, direct): direct {stem_ms['direct'][0]:.4f} / "
        f"{stem_ms['direct'][1]:.4f} ms, space-to-depth {stem_ms['s2d'][0]:.4f} / "
        f"{stem_ms['s2d'][1]:.4f} ms (s2d / direct "
        f"{statistics.mean(stem_ms['s2d']) / statistics.mean(stem_ms['direct']):.3f})")
    log(f"[times] M5 frame bucket (direct stem, model only, CUDA-event medians of {REPS // 2}, "
        f"in turns up then down): " + ", ".join(
            f"{b}: {t[0]:.4f} / {t[1]:.4f} ms" for b, t in bucket_ms.items()))
    log(f"[times] MobileNetV1 batch {BATCH} x {SECONDS} s {mn_batch_ms:.4f} ms "
        f"({BATCH * SECONDS / mn_batch_ms * 1e3:.1f} audio-s/s)")
    log(f"[files] times {time.perf_counter() - t1:.1f} s; phase {time.perf_counter() - t0:.1f} s")
    return {k: sum(file_launches[a].get(k, 0) for a in file_launches)
            for k in ("wave_stft_power", "mel_log")}


def main() -> int:
    import torch

    phase_t0 = time.perf_counter()
    # ---- 1. card ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; chip_smoke needs a "
              "CUDA card", file=sys.stderr)
        return 1
    from sed_tpu_torch.configs import DEFAULT_SPECTROGRAM as cfg
    from sed_tpu_torch.inference import make_batch_predictor
    from sed_tpu_torch.models.cnn import TRAIN_CHANNEL_AND_POOL, CnnAvgPooling
    from sed_tpu_torch.ops import cuda_featurizer as kernels
    from sed_tpu_torch.ops.featurizer import logmel_features_batch, logmel_frames
    from sed_tpu_torch.ops.mel import mel_filterbank
    from sed_tpu_torch.ops.mulaw import mulaw_encode

    dev = torch.device(DEVICE, 0)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = smi_line()
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device 0: {name}, device count {count}")
    log(f"[card] nvidia-smi: {smi}")
    start_lesions(kernels)
    info = kernels.build(force=True)
    log(f"[card] nvcc build: {info.seconds:.2f} s -> {info.path.relative_to(REPO)}")
    for line in info.log.splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill")):
            log(f"[card] ptxas: {line.strip()}")
    n_seg = kernels.mel_bands(cfg, torch.device("cpu")).n_segments
    log(f"[card] K1 wave_stft_power_kernel, K3 frames_stft_power_kernel and K6 "
        f"wave_packed_fft_kernel at n_fft {cfg.nfft}: {cfg.nfft // 32} threads a frame "
        f"(row), {4 * cfg.nfft} B of dynamic shared memory (the exchange buffer); K5 "
        f"wave_stft_mel_log_kernel the same threads, "
        f"{6 * cfg.nfft + 4 + 4 * (n_seg + kernels.MEL_SEGMENT_BINS)} B (the exchange buffer, "
        f"the power row, the sums of the {n_seg} segments, the segment loads' slack)")
    bw, flops_peak = card_peaks(name)

    sr, hop, n_fft, n_bins = cfg.working_sample_rate, cfg.hop_size, cfg.nfft, cfg.freq_bins
    m = n_fft // 2
    samples = sr * SECONDS
    chunk = sr                                  # 1 s chunks
    frames_max = -(-chunk // hop) + 1           # new frames per slot per tick
    k3_rows = POOL_SLOTS * frames_max
    window = kernels.stft_window(cfg, dev)
    win_nnz = int(torch.count_nonzero(window))
    bands = kernels.mel_bands(cfg, dev)
    fb64 = torch.from_numpy(mel_filterbank(cfg, np.float64)).to(dev)

    def bound(n_bytes, n_ops):
        t_bytes, t_ops = n_bytes / bw * 1e3, n_ops / flops_peak * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    # ---- 2. kernels vs their plain versions (float64) ---------------------
    t0 = time.perf_counter()
    waves = make_signals(torch, BATCH, samples, sr, dev, 0)
    power = kernels.wave_stft_power(waves, window, hop, n_fft)
    ref = kernels.wave_stft_power_plain(waves.double(), window, hop, n_fft)
    torch.cuda.synchronize()
    check(power.shape == ref.shape == (BATCH, 1 + samples // hop, n_bins),
          f"K1 shape {tuple(power.shape)}")
    k1_err = (power.double() - ref).abs()
    k1_abs = float(k1_err.max())
    k1_rel = float((k1_err / ref.amax(dim=-1, keepdim=True).clamp_min(1e-30)).max())
    log(f"[kernels] K1 wave_stft_power {tuple(power.shape)}: max abs err {k1_abs:.3e}, "
        f"max err / frame peak {k1_rel:.3e} (tol {K1_REL_TOL})")
    check(k1_rel <= K1_REL_TOL, "K1 within 1e-5 x frame peak of float64")
    rows = power.reshape(-1, n_bins)
    mel = kernels.mel_log(rows, bands)
    k2_err = float((mel.double() - kernels.mel_log_plain(rows.double(), fb64)).abs().max())
    chain_err = float((mel.double() - kernels.mel_log_plain(
        ref.reshape(-1, n_bins), fb64)).abs().max())
    log(f"[kernels] K2 mel_log {tuple(mel.shape)}: max err {k2_err:.3e} dB "
        f"(tol {DB_TOL}); K1+K2 vs float64 chain: {chain_err:.3e} dB (tol {DB_TOL})")
    check(k2_err <= DB_TOL, "K2 within 1e-4 dB of float64")
    check(chain_err <= DB_TOL, "K1+K2 within 1e-4 dB of the float64 chain")
    # Rows from an odd row on (not on a 16-byte boundary), up to the last row
    # of the allocation: the same values as the aligned rows, bit for bit.
    odd = rows[1:]
    odd_mel = kernels.mel_log(odd, bands)
    torch.cuda.synchronize()
    check(odd.data_ptr() % 16 != 0, "the view starts off a 16-byte boundary")
    check(torch.equal(odd_mel, mel[1:]), "K2 on unaligned rows equals K2 on aligned rows")
    log(f"[kernels] K2 mel_log on rows 1.. (base {odd.data_ptr() % 16} bytes past a 16-byte "
        f"boundary, up to the allocation's end): equal to the aligned rows' result")
    del power, ref, k1_err, rows, mel, odd, odd_mel

    # K3 at the tick's shape: 10 frames of each of the 16 signals (signal 0's
    # are silent, signal 15's quiet), as float32 and as int16 PCM.
    per = k3_rows // BATCH
    frames_f32 = waves[:, : n_fft + (per - 1) * hop].unfold(1, n_fft, hop)
    frames_f32 = frames_f32.reshape(-1, n_fft)[:k3_rows].contiguous()
    frames_i16 = (frames_f32 * 32767).round().to(torch.int16)
    k3 = {}
    for tag, x in (("float32", frames_f32), ("int16", frames_i16)):
        got = kernels.frames_stft_power(x, window, n_fft)
        want = kernels.frames_stft_power_plain(x, window, n_fft, dtype=torch.float64)
        lm = logmel_frames(x, cfg)
        torch.cuda.synchronize()
        check(got.shape == want.shape == (k3_rows, n_bins), f"K3 {tag} shape {tuple(got.shape)}")
        err = (got.double() - want).abs()
        rel = float((err / want.amax(dim=-1, keepdim=True).clamp_min(1e-30)).max())
        db = float((lm.double() - kernels.mel_log_plain(want, fb64)).abs().max())
        k2_tick = float((kernels.mel_log(got, bands).double()
                         - kernels.mel_log_plain(got.double(), fb64)).abs().max())
        k3[tag] = float(err.max())
        log(f"[kernels] K3 frames_stft_power {tag} {tuple(got.shape)}: max abs err "
            f"{k3[tag]:.3e}, max err / row peak {rel:.3e} (tol {K1_REL_TOL}); "
            f"logmel_frames vs float64 chain {db:.3e} dB (tol {DB_TOL}); K2 on its "
            f"{k3_rows} rows vs float64 {k2_tick:.3e} dB (tol {DB_TOL})")
        check(rel <= K1_REL_TOL, f"K3 {tag} within 1e-5 x row peak of float64")
        check(db <= DB_TOL, f"K3+K2 {tag} within 1e-4 dB of the float64 chain")
        check(k2_tick <= DB_TOL, "K2 at the tick's rows within 1e-4 dB of float64")
    del waves, got, want, err, lm
    log(f"[kernels] launches so far {kernels.LAUNCHES}; "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- 3. the slice through make_batch_predictor ------------------------
    t0 = time.perf_counter()
    model = CnnAvgPooling(cfg.classes_num, TRAIN_CHANNEL_AND_POOL,
                          generator=torch.Generator().manual_seed(0))
    cpu_model = copy.deepcopy(model)
    pcm = (make_signals(torch, BATCH, samples, sr, dev, 1)
           * 32767).round().to(torch.int16)[..., None]
    mu = torch.from_numpy(mulaw_encode(pcm.cpu().numpy())).to(dev)
    # Per-mel-bin normalization statistics, as preprocessing computes them
    # from training features; they keep the random model out of saturation.
    with torch.inference_mode():
        feats = logmel_features_batch(pcm[:4], cfg)
    mean = feats.mean(dim=(0, 1, 2)).cpu().numpy()
    std = feats.std(dim=(0, 1, 2)).cpu().numpy()
    predict = make_batch_predictor(model, cfg, mean=mean, std=std, device=DEVICE)
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    scores = predict(pcm)
    scores_mu = predict(mu)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(f"[slice] launches on the batch path: {launches}")
    check(launches["wave_stft_power"] > 0 and launches["mel_log"] > 0,
          "K1 and K2 ran on the batch path")
    n_out = 8 * ((((1 + samples // hop) // 2) // 2) // 2)
    for tag, s in (("int16", scores), ("uint8", scores_mu)):
        check(s.shape == (BATCH, n_out, cfg.classes_num), f"{tag} scores shape {tuple(s.shape)}")
        check(bool(torch.isfinite(s).all()), f"{tag} scores finite")
        check(bool(((s >= 0) & (s <= 1)).all()), f"{tag} scores in [0, 1]")
        log(f"[slice] {tag} scores {tuple(s.shape)}: min {float(s.min()):.6f} "
            f"max {float(s.max()):.6f}")
    cpu_predict = make_batch_predictor(cpu_model, cfg, mean=mean, std=std, device="cpu")
    cpu_err = float((scores[:1].cpu() - cpu_predict(pcm[:1].cpu())).abs().max())
    cpu_err_mu = float((scores_mu[:1].cpu() - cpu_predict(mu[:1].cpu())).abs().max())
    log(f"[slice] clip 0, card vs CPU: int16 {cpu_err:.3e}, uint8 {cpu_err_mu:.3e} "
        f"(tol {SCORE_TOL}); {time.perf_counter() - t0:.1f} s")
    check(cpu_err <= SCORE_TOL and cpu_err_mu <= SCORE_TOL, "clip 0 matches the CPU path")
    del cpu_model, cpu_predict

    from scipy.io import wavfile

    from sed_tpu_torch.io.audio import read_multichannel_audio

    tmp_dir = tempfile.TemporaryDirectory()
    tmp = Path(tmp_dir.name)
    torch.save({"iterations": 0, "model": model.state_dict(), "optimizer": {}},
               tmp / "model.pth")
    with open(tmp / "mean_std.pkl", "wb") as f:
        pickle.dump({"mean": mean, "std": std}, f)
    common = ["--ckpt", tmp / "model.pth", "--mean_std_file", tmp / "mean_std.pkl",
              "--device", DEVICE]

    def check_cli_outputs(out, wavs, tag):
        err = 0.0
        for path in wavs:
            got = np.load(out / f"{path.stem}_scores.npy")
            wav = read_multichannel_audio(str(path), target_fs=sr, cfg=cfg)
            want = predict(wav[None].astype(np.float32))[0].cpu().numpy()
            check(got.shape == want.shape, f"{tag} scores shape {got.shape} != {want.shape}")
            err = max(err, float(np.abs(got - want).max()))
            check((out / f"{path.stem}_events.csv").is_file(), f"{tag} wrote events")
        check(err <= SCORE_TOL, f"{tag} scores match make_batch_predictor")
        return err

    # ---- 4. the batch CLI entry point --------------------------------------
    t0 = time.perf_counter()
    wavs = []
    for i, secs in enumerate((20, 30)):
        path = tmp / f"clip{i}.wav"
        wavfile.write(path, sr, pcm[i, : secs * sr, 0].cpu().numpy())
        wavs.append(path)
    out = tmp / "out_infer"
    run_cli(["sed_tpu_torch.cli.infer", "--batch", "--no_plot", *common, "--outputs_dir", out,
             "--event_threshold", "0.5", *wavs], "cli.infer")
    for path in wavs:
        check((out / f"{path.stem}_scores.csv").is_file(), "cli.infer wrote scores csv")
    cli_err = check_cli_outputs(out, wavs, "cli.infer")
    log(f"[cli] {len(wavs)} files scored by sed_tpu_torch.cli.infer --batch; "
        f"max diff vs make_batch_predictor {cli_err:.3e} (tol {SCORE_TOL}); "
        f"{time.perf_counter() - t0:.1f} s")
    del pcm, mu, scores, scores_mu

    # ---- 5. the streaming pool at full width (the main path) ---------------
    from sed_tpu_torch.stream_pool import StreamPool

    t0 = time.perf_counter()
    pool_samples = sr * POOL_SECONDS
    audio = (make_signals(torch, POOL_SLOTS, pool_samples, sr, dev, 2) * 32767
             ).round().to(torch.int16).cpu().numpy()
    clips = [audio[i] for i in range(POOL_SLOTS)]
    clips[EARLY_LEAVER] = clips[EARLY_LEAVER][: int(EARLY_SECONDS * sr)]
    pool = StreamPool(model, cfg, slots=POOL_SLOTS, chunk_samples=chunk, mean=mean,
                      std=std, device=DEVICE)
    pool.profile = {}
    rng = np.random.default_rng(2)
    recs = [{"wav": c, "pos": 0, "blocks": []} for c in clips]
    waiting = list(range(POOL_SLOTS))
    active, tick = {}, 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    run_t0 = time.perf_counter()
    while waiting or active:
        for i in [i for i in waiting if LATE_JOINS.get(i, 0) <= tick]:
            active[pool.join()] = recs[i]
            waiting.remove(i)
        leaving = []
        for slot, rec in active.items():
            piece = rec["wav"][rec["pos"]: rec["pos"] + int(chunk * rng.uniform(0.4, 1.6))]
            pool.feed(slot, piece)
            rec["pos"] += len(piece)
            if rec["pos"] >= len(rec["wav"]):
                leaving.append(slot)
        for slot, sc in pool.tick().items():
            active[slot]["blocks"].append(sc)
        tails = pool.leave_many(leaving) if leaving else {}
        for slot in leaving:
            tail = tails[slot]
            if isinstance(tail, Exception):
                raise tail
            active.pop(slot)["blocks"].append(tail)
        tick += 1
    torch.cuda.synchronize()
    pool_wall = time.perf_counter() - run_t0
    pool_launches = dict(kernels.LAUNCHES)
    pool_peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20
    pool_audio_s = sum(len(c) for c in clips) / sr
    log(f"[pool] {POOL_SLOTS} streams ({len(LATE_JOINS)} joining late, stream "
        f"{EARLY_LEAVER} leaving after {EARLY_SECONDS} s), {tick} ticks; launches "
        f"on the main path: {pool_launches}")
    check(pool_launches["frames_stft_power"] > 0 and pool_launches["mel_log"] > 0,
          "K3 and K2 ran on the streaming path")
    full = [i for i in range(POOL_SLOTS) if i != EARLY_LEAVER]
    want = dict(zip(full, score_all(torch, predict, [clips[i] for i in full])))
    want[EARLY_LEAVER] = score_all(torch, predict, [clips[EARLY_LEAVER]])[0]
    pool_err = 0.0
    for i, rec in enumerate(recs):
        got = np.concatenate(rec["blocks"])
        check(got.shape == want[i].shape,
              f"stream {i}: {got.shape[0]} frames, offline {want[i].shape[0]}")
        pool_err = max(pool_err, float(np.abs(got - want[i]).max()))
    log(f"[pool] every stream's frame count equals offline; max diff vs "
        f"make_batch_predictor {pool_err:.3e} (tol {SCORE_TOL}); "
        f"{time.perf_counter() - t0:.1f} s")
    check(pool_err <= SCORE_TOL, "pool scores match make_batch_predictor")
    profile = pool.profile
    del pool, recs

    # ---- 6. the streaming CLI ----------------------------------------------
    t0 = time.perf_counter()
    wavs = []
    for i, secs in enumerate(CLI_SECONDS):
        path = tmp / f"stream{i}.wav"
        wavfile.write(path, sr, audio[i, : int(secs * sr)])
        wavs.append(path)
    out = tmp / "out_stream"
    stdout = run_cli(["sed_tpu_torch.cli.stream", *common, "--outputs_dir", out,
                      "--slots", "2", "--stagger_ticks", "2", "--event_threshold",
                      "0.5", *wavs], "cli.stream")
    summary = json.loads(stdout.strip().splitlines()[-1])
    cli_launches = summary["kernel_launches"]
    check(cli_launches["frames_stft_power"] > 0 and cli_launches["mel_log"] > 0,
          "K3 and K2 ran in cli.stream")
    stream_err = check_cli_outputs(out, wavs, "cli.stream")
    log(f"[stream] {len(wavs)} files scored by sed_tpu_torch.cli.stream "
        f"(2 slots, staggered) in {summary['ticks']} ticks; launches {cli_launches}; "
        f"max diff vs make_batch_predictor {stream_err:.3e} (tol {SCORE_TOL}); "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- 7. the live TCP server --------------------------------------------
    from sed_tpu_torch.cli.serve_socket import warmup_pool
    from sed_tpu_torch.serve_socket import StreamClient, StreamServer

    t0 = time.perf_counter()
    server_launches = dict.fromkeys(kernels.LAUNCHES, 0)
    server_err = 0.0
    for wire, secs in (("pcm16", SERVER_SECONDS), ("mulaw", (MULAW_SECONDS,))):
        sent = [audio[i, : int(s * sr)] for i, s in enumerate(secs)]
        spool = StreamPool(model, cfg, slots=len(sent), chunk_samples=chunk,
                           mean=mean, std=std, device=DEVICE)
        warmup_pool(spool, wire)
        kernels.reset_launch_counts()
        server = StreamServer(spool, host="127.0.0.1", port=0, tick_interval=0.02,
                              wire=wire)
        server.start()
        results = {}

        def client(i, y, server=server, wire=wire, results=results):
            try:
                c = StreamClient(*server.address, classes_num=cfg.classes_num, wire=wire)
                for pos in range(0, len(y), 20000):
                    c.send(y[pos: pos + 20000])
                results[i] = c.finish()
            except Exception as e:  # noqa: BLE001 - reported below
                results[i] = e

        try:
            threads = [threading.Thread(target=client, args=(i, y))
                       for i, y in enumerate(sent)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
                check(not t.is_alive(), f"{wire} client finished")
        finally:
            server.stop()
        for k, n in kernels.LAUNCHES.items():
            server_launches[k] += n
        for i, y in enumerate(sent):
            got = results[i]
            if isinstance(got, Exception):
                raise got
            ref = score_all(torch, predict, [mulaw_encode(y) if wire == "mulaw" else y])[0]
            check(got.shape == ref.shape, f"{wire} client {i}: {got.shape} != {ref.shape}")
            server_err = max(server_err, float(np.abs(got - ref).max()))
    log(f"[server] {len(SERVER_SECONDS)} pcm16 clients and 1 mulaw client on "
        f"127.0.0.1; launches {server_launches}; max diff vs offline "
        f"{server_err:.3e} (tol {SCORE_TOL}); {time.perf_counter() - t0:.1f} s")
    check(server_launches["frames_stft_power"] > 0 and server_launches["mel_log"] > 0,
          "K3 and K2 ran in the server")
    check(server_err <= SCORE_TOL, "server scores match offline")
    tmp_dir.cleanup()

    # ---- 8. times ------------------------------------------------------------
    t0 = time.perf_counter()
    pcm = torch.from_numpy(audio[:BATCH, :samples]).to(dev)[..., None]
    signals = (pcm[..., 0].float() / 32768.0).contiguous()
    power = kernels.wave_stft_power(signals, window, hop, n_fft)
    rows = power.reshape(-1, n_bins)
    frames = rows.shape[0]
    k1_ms = time_ms(torch, lambda: kernels.wave_stft_power(signals, window, hop, n_fft))
    k1_plain_ms = time_ms(torch, lambda: kernels.wave_stft_power_plain(
        signals, window, hop, n_fft))
    k1_lib_ms = time_ms(torch, lambda: torch.stft(
        signals, n_fft, hop, window=window, center=True, pad_mode="reflect",
        return_complex=True).abs() ** 2)
    k2_ms = time_ms(torch, lambda: kernels.mel_log(rows, bands))
    k2_plain_ms = time_ms(torch, lambda: kernels.mel_log_plain(rows, bands.dense))
    k2_lib_ms = time_ms(torch, lambda: 10.0 * torch.log10(
        torch.clamp(torch.matmul(rows, bands.dense), min=1e-10)))
    with torch.inference_mode():
        feats = logmel_features_batch(pcm, cfg)
        feat_ms = time_ms(torch, lambda: logmel_features_batch(pcm, cfg))
        model_ms = time_ms(torch, lambda: model(feats))
    torch.cuda.reset_peak_memory_stats(dev)
    batch_ms = time_ms(torch, lambda: predict(pcm))
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20
    audio_s_per_s = BATCH * SECONDS / (batch_ms / 1e3)
    del power, feats

    # K3 on a tick's frames: the first frames_max frames of every stream.
    tick_frames = (torch.from_numpy(audio[:, : n_fft + (frames_max - 1) * hop]).to(dev)
                   .float() / 32768.0).unfold(1, n_fft, hop).reshape(-1, n_fft).contiguous()
    # One call between two events, as every kernel here (launch latency
    # included); K3 takes tens of microseconds, so also queued (QUEUED calls
    # in a row), which times the device work alone.
    k3_calls = {
        "k3": lambda: kernels.frames_stft_power(tick_frames, window, n_fft),
        "plain": lambda: kernels.frames_stft_power_plain(tick_frames, window, n_fft),
        "lib": lambda: torch.fft.rfft(tick_frames * window).abs() ** 2,
    }
    k3_ms, k3_plain_ms, k3_lib_ms = (time_ms(torch, fn) for fn in k3_calls.values())
    k3_q_ms, k3_q_plain_ms, k3_q_lib_ms = (time_ms(torch, fn, calls=QUEUED)
                                           for fn in k3_calls.values())
    # K3 without its drain's exchange (wrong results): what the exchange
    # costs, against K3 through the same C call.
    lesions = finish_lesions()
    k3_out = kernels.frames_stft_power(tick_frames, window, n_fft)
    k3_tables = (kernels._stockham_twiddles(n_fft, dev), kernels._twiddles(n_fft, dev))
    k3_stream = torch.cuda.current_stream(dev).cuda_stream

    def k3_raw_run(fn):
        err = fn(tick_frames.data_ptr(), 0, window.data_ptr(), k3_tables[0].data_ptr(),
                 k3_tables[1].data_ptr(), k3_out.data_ptr(), tick_frames.shape[0],
                 n_fft.bit_length() - 2, dev.index, k3_stream)
        check(err == 0, f"K3 raw launch ({err})")

    k3_lesion_ms = time_ms(torch, lambda: k3_raw_run(lesions["K3 drain exchange"]),
                           calls=QUEUED)
    k3_again_ms = time_ms(torch, lambda: k3_raw_run(kernels._library().sed_frames_stft_power),
                          calls=QUEUED)
    del k3_out
    # K1 likewise, on the batch.
    k1_out = kernels.wave_stft_power(signals, window, hop, n_fft)

    def k1_raw_run(fn):
        err = fn(signals.data_ptr(), window.data_ptr(), k3_tables[0].data_ptr(),
                 k3_tables[1].data_ptr(), k1_out.data_ptr(), BATCH, samples, k1_out.shape[1],
                 hop, n_fft.bit_length() - 2, dev.index, k3_stream)
        check(err == 0, f"K1 raw launch ({err})")

    k1_lesion_ms = time_ms(torch, lambda: k1_raw_run(lesions["K1 drain exchange"]))
    k1_again_ms = time_ms(torch, lambda: k1_raw_run(kernels._library().sed_wave_stft_power))
    del k1_out

    # K2 at the tick's rows (K3's power of the tick frames): one call, and
    # QUEUED calls in a row.
    tick_power = kernels.frames_stft_power(tick_frames, window, n_fft)
    k2t_calls = {
        "k2": lambda: kernels.mel_log(tick_power, bands),
        "plain": lambda: kernels.mel_log_plain(tick_power, bands.dense),
        "lib": lambda: 10.0 * torch.log10(torch.clamp(torch.matmul(tick_power, bands.dense),
                                                      min=1e-10)),
    }
    k2t_ms = time_ms(torch, k2t_calls["k2"])
    k2t_q_ms, k2t_q_plain_ms, k2t_q_lib_ms = (time_ms(torch, fn, calls=QUEUED)
                                              for fn in k2t_calls.values())
    # K2 without its copies, and without its sums (wrong results): each side
    # alone, against K2 through the same C call.

    def k2_raw_run(fn, x, out):
        err = fn(x.data_ptr(), bands.segments.data_ptr(), bands.band_first.data_ptr(),
                 bands.work.data_ptr(), bands.weights.data_ptr(), out.data_ptr(), x.shape[0],
                 n_bins, bands.n_mels, bands.n_segments, *bands.span, dev.index, k3_stream)
        check(err == 0, f"K2 raw launch ({err})")

    k2_out = torch.empty(frames, bands.n_mels, device=dev)
    k2t_out = torch.empty(tick_power.shape[0], bands.n_mels, device=dev)
    k2_raw = kernels._library().sed_mel_log
    k2_lesion_ms = time_ms(torch, lambda: k2_raw_run(lesions["K2 copies"], rows, k2_out))
    k2_copies_ms = time_ms(torch, lambda: k2_raw_run(lesions["K2 sums"], rows, k2_out))
    k2_again_ms = time_ms(torch, lambda: k2_raw_run(k2_raw, rows, k2_out))
    k2t_lesion_ms = time_ms(torch, lambda: k2_raw_run(lesions["K2 copies"], tick_power, k2t_out),
                            calls=QUEUED)
    k2t_copies_ms = time_ms(torch, lambda: k2_raw_run(lesions["K2 sums"], tick_power, k2t_out),
                            calls=QUEUED)
    k2t_again_ms = time_ms(torch, lambda: k2_raw_run(k2_raw, tick_power, k2t_out), calls=QUEUED)
    del k2_out, k2t_out

    # The 32-slot pool's tick: every slot admitted, int16 chunks.
    tpool = StreamPool(model, cfg, slots=POOL_SLOTS, chunk_samples=chunk, mean=mean,
                       std=std, device=DEVICE)
    tslots = [tpool.join() for _ in range(POOL_SLOTS)]
    for k in range(2):
        tpool.push({s: audio[s, k * chunk: (k + 1) * chunk] for s in tslots})
    check(len(tpool._admitted) == POOL_SLOTS, "every timing slot admitted")
    one = {s: audio[s, 2 * chunk: 3 * chunk] for s in tslots}
    tick_ms = time_ms(torch, lambda: tpool._push_rounds([one]))
    block_ms = time_ms(torch, lambda: tpool._push_rounds(
        [one] * StreamPool.ROUNDS_PER_CALL), reps=5, warmup=1)
    tick_kernels = profile_ticks(torch, lambda: tpool._push_rounds([one]), n=5)
    del tpool

    # Waveform, window, the two twiddle tables (pass-ordered and W_N^k), power.
    k1_bytes = 4 * (signals.numel() + n_fft + 4 * m + rows.numel())
    k1_bound, k1_by = bound(k1_bytes, fft_ops(frames, m, win_nnz))
    nnz = bands.nnz
    # Power, out, and the band tables: weights, segments (4 int32 each),
    # work, band_first.
    k2_tables = 4 * (nnz + 5 * bands.n_segments + bands.n_mels + 1)
    k2_bytes = 4 * (rows.numel() + frames * bands.n_mels) + k2_tables
    k2_ops = frames * 2 * nnz
    k2_bound, k2_by = bound(k2_bytes, k2_ops)
    k2t_n = tick_power.shape[0]
    k2t_bytes = 4 * (tick_power.numel() + k2t_n * bands.n_mels) + k2_tables
    k2t_bound, k2t_by = bound(k2t_bytes, k2t_n * 2 * nnz)
    k3_n = tick_frames.shape[0]
    # Rows, window, the two twiddle tables (pass-ordered and W_N^k), power.
    k3_bytes = 4 * (tick_frames.numel() + n_fft + 4 * m + k3_n * (m + 1))
    k3_ops = fft_ops(k3_n, m, win_nnz)
    k3_bound, k3_by = bound(k3_bytes, k3_ops)
    log(f"[times] {smi}; CUDA-event median of {REPS} unless stated")
    log(f"[times] batch path, {BATCH} x {SECONDS} s, {frames} frames:")
    log(f"[times] K1 wave_stft_power {k1_ms:.4f} ms | plain {k1_plain_ms:.4f} ms | "
        f"torch.stft+abs^2 {k1_lib_ms:.4f} ms | bound {k1_bound:.4f} ms ({k1_by}: "
        f"{k1_bytes / 1e6:.1f} MB, {fft_ops(frames, m, win_nnz) / 1e9:.2f} GFLOP) | bound "
        f"share {k1_bound / k1_ms:.1%} | K1 / torch.stft+abs^2 {k1_ms / k1_lib_ms:.3f}")
    log(f"[times] K1 without its drain's exchange (wrong results, timing only) "
        f"{k1_lesion_ms:.4f} ms; K1 through the same C call {k1_again_ms:.4f} ms (the "
        f"exchange's share {k1_again_ms - k1_lesion_ms:.4f} ms)")
    log(f"[times] K2 mel_log {k2_ms:.4f} ms | plain {k2_plain_ms:.4f} ms | "
        f"matmul+log10 {k2_lib_ms:.4f} ms | bound {k2_bound:.4f} ms ({k2_by}: "
        f"{k2_bytes / 1e6:.1f} MB, {k2_ops / 1e9:.3f} GFLOP) | bound share "
        f"{k2_bound / k2_ms:.1%} | K2 / matmul+log10 {k2_ms / k2_lib_ms:.3f}")
    log(f"[times] K2 without its copies (wrong results, timing only) {k2_lesion_ms:.4f} ms; "
        f"without its sums {k2_copies_ms:.4f} ms; K2 through the same C call "
        f"{k2_again_ms:.4f} ms (what the copies add to the sums {k2_again_ms - k2_lesion_ms:.4f} "
        f"ms, the sums to the copies {k2_again_ms - k2_copies_ms:.4f} ms)")
    log(f"[times] featurizer (int16 ingest + K1 + K2) {feat_ms:.4f} ms | "
        f"CnnAvgPooling {model_ms:.4f} ms | whole batch {batch_ms:.4f} ms")
    log(f"[times] {audio_s_per_s:.1f} audio-s/s; peak device memory {peak_mib:.1f} MiB")
    log(f"[times] streaming path, {POOL_SLOTS} slots x 1 s chunks, {k3_n} frames a tick:")
    log(f"[times] K3 frames_stft_power {k3_ms:.4f} ms | plain {k3_plain_ms:.4f} ms | "
        f"rfft+abs^2 {k3_lib_ms:.4f} ms | bound {k3_bound:.4f} ms ({k3_by}: "
        f"{k3_bytes / 1e6:.1f} MB, {k3_ops / 1e9:.3f} GFLOP) | bound share "
        f"{k3_bound / k3_ms:.1%} | K3 / rfft+abs^2 {k3_ms / k3_lib_ms:.3f}")
    log(f"[times] K3 queued ({QUEUED} calls between two events, per call) {k3_q_ms:.4f} ms "
        f"| plain {k3_q_plain_ms:.4f} ms | rfft+abs^2 {k3_q_lib_ms:.4f} ms | bound share "
        f"{k3_bound / k3_q_ms:.1%} | K3 / rfft+abs^2 {k3_q_ms / k3_q_lib_ms:.3f}")
    log(f"[times] K3 without its drain's exchange (wrong results, timing only, queued) "
        f"{k3_lesion_ms:.4f} ms; K3 through the same C call {k3_again_ms:.4f} ms (the "
        f"exchange's share {k3_again_ms - k3_lesion_ms:.4f} ms)")
    log(f"[times] K2 mel_log at the tick's {k2t_n} rows {k2t_ms:.4f} ms | bound "
        f"{k2t_bound:.4f} ms ({k2t_by}: {k2t_bytes / 1e6:.2f} MB) | bound share "
        f"{k2t_bound / k2t_ms:.1%}")
    log(f"[times] K2 at {k2t_n} rows queued ({QUEUED} calls between two events, per call) "
        f"{k2t_q_ms:.4f} ms | plain {k2t_q_plain_ms:.4f} ms | matmul+log10 {k2t_q_lib_ms:.4f} "
        f"ms | bound share {k2t_bound / k2t_q_ms:.1%} | K2 / matmul+log10 "
        f"{k2t_q_ms / k2t_q_lib_ms:.3f}")
    log(f"[times] K2 at {k2t_n} rows without its copies (wrong results, timing only, queued) "
        f"{k2t_lesion_ms:.4f} ms; without its sums {k2t_copies_ms:.4f} ms; K2 through the "
        f"same C call {k2t_again_ms:.4f} ms")
    log(f"[times] pool tick, one round of {POOL_SLOTS} slots: {tick_ms:.4f} ms | "
        f"one {StreamPool.ROUNDS_PER_CALL}-round block: {block_ms:.4f} ms (median of 5)")
    if tick_kernels:
        busy = sum(ms for _, ms in tick_kernels)
        log(f"[times] pool tick on the device (torch.profiler, 5 ticks): "
            f"{busy:.4f} ms of kernels a tick, {busy / tick_ms:.1%} of the "
            f"{tick_ms:.4f} ms tick; the 8 largest and the port's own:")
        for i, (kname, ms) in enumerate(tick_kernels):
            if i < 8 or any(k in kname for k in kernels.LAUNCHES):
                log(f"[times]   {ms:.4f} ms  {kname[:90]}")
    else:
        log("[times] pool tick on the device: torch.profiler captured no device "
            "time (not measured)")
    log(f"[times] pool run profile: " + ", ".join(
        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in sorted(profile.items())))
    log(f"[times] pool run: {pool_audio_s:.1f} audio-s in {pool_wall:.3f} wall-s = "
        f"{pool_audio_s / pool_wall:.1f} audio-s per wall-s; peak device memory "
        f"{pool_peak_mib:.1f} MiB")
    log(f"[times] {time.perf_counter() - t0:.1f} s; total "
        f"{time.perf_counter() - phase_t0:.1f} s")

    impl_entries = impls_phase(torch, cfg, dev, bound, win_nnz, lesions)
    log(f"[times] total {time.perf_counter() - phase_t0:.1f} s")

    # ---- 10. the per-file path --------------------------------------------
    with tempfile.TemporaryDirectory() as files_tmp:
        file_launches = files_phase(torch, cfg, dev, smi, Path(files_tmp))
    log(f"[files] total {time.perf_counter() - phase_t0:.1f} s")

    source = "sed_tpu_torch/ops/csrc/featurizer.cu"
    print(json.dumps({"kernels": [
        {"name": "wave_stft_power",
         "kernel": "wave_stft_power_kernel<LOG2_M> (stockham_fft, PackedWaveLoad, PowerStore)",
         "route": "cuda", "source": source,
         "replaces": "sed_tpu/ops/pallas_featurizer.py:412",
         "launches": launches["wave_stft_power"],
         "file_launches": file_launches["wave_stft_power"], "max_abs_err": k1_abs,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": k1_lib_ms},
        {"name": "mel_log",
         "kernel": "mel_log_kernel<R> (bulk copies into a ring, segment_sums)",
         "route": "cuda", "source": source,
         "replaces": "sed_tpu/ops/pallas_featurizer.py:72",
         "launches": launches["mel_log"], "file_launches": file_launches["mel_log"],
         "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": k2_lib_ms, "tick_rows": k2t_n,
         "tick_ms": k2t_ms, "tick_queued_ms": k2t_q_ms,
         "tick_queued_plain_ms": k2t_q_plain_ms, "tick_queued_library_ms": k2t_q_lib_ms,
         "tick_bound_ms": k2t_bound, "pool_launches": pool_launches["mel_log"]},
        {"name": "frames_stft_power",
         "kernel": "frames_stft_power_kernel<LOG2_M, Pair> (stockham_fft, PowerStore)",
         "route": "cuda", "source": source,
         "replaces": "sed_tpu/ops/pallas_featurizer.py:283",
         "launches": pool_launches["frames_stft_power"], "max_abs_err": k3["float32"],
         "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
         "bound_by": k3_by, "library_ms": k3_lib_ms, "queued_ms": k3_q_ms,
         "queued_plain_ms": k3_q_plain_ms, "queued_library_ms": k3_q_lib_ms},
        *impl_entries,
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        stop_lesions()
