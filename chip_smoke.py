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
 11. train    training of the spectrogram family on the card: a seeded
              FilmClap-layout corpus (32 x 60 s 48 kHz int16 WAVs, 3-5 s
              tonal bursts as the labelled events) preprocessed in logMel
              mode by ``preprocess_film_clap_data`` (exactly one K1 and one
              K2 launch a file, counts reset just before and read just
              after; one file within 1e-4 dB of ``device="cpu"``) and 8 of
              them in Complex mode (no launch); ``train`` of CnnAvgPooling
              (TRAIN_CHANNEL_AND_POOL) at batch 128, 400 steps at lr 3e-3:
              the validation loss falls and AP > max(AP0, 0.5), metrics.jsonl
              with sed_tpu's keys, no featurizer launch while training; the
              first 5 steps on the card against the CPU from one state, in
              float64 (losses 1e-4 relative, first gradients 1e-4 of each
              tensor's largest; in float32 the card's BatchNorm backward
              sums in float32 and its gradients part from float64 by ~4e-3,
              so the first float32 loss is compared and the float32
              gradients reported); resume from a checkpoint at step 10 equal
              to the uninterrupted run (cuDNN deterministic for both), and
              the checkpoint scored through ``cli/infer.load_model``;
              Complex mode with augmentation (finite losses, the transform
              card against CPU within 1e-4 dB); MobileNetV1 (emit='logits');
              ``make_batch_evaluator`` on 4 x 60 s int16 clips against
              ``make_batch_predictor`` (one K1 and one K2 launch); times:
              the train step for each arch, mode and augmentation, its split
              by profiler range, im/sec, evaluate ms per recording,
              preprocess ms per file (read, featurize), peak memory.

 12. wavetrain M5 training on the card, on phase 11's corpus:
              ``WaveformDataset`` (0.25 validation) and
              ``waveform_buffers_from_dataset`` (one upload);
              ``train(mode="waveform")`` of M5(1) at batch 128 x 31,680
              samples, 400 steps at lr 3e-3: the validation loss falls and AP
              > max(AP0, 0.5), metrics.jsonl with sed_tpu's keys, no launch of
              any K1–K10 kernel while training (counts reset just before, read
              just after); the first 5 steps on the card against the CPU from
              one state in float64 at batch 32 (losses 1e-4 relative, first
              gradients 1e-4 of each tensor's largest), the first float32
              loss, and the float32 gradients' distance from float64;
              augmentation on (finite losses, the apply card against CPU
              within 1e-6 on one set of draws); ``make_multi_step`` with K = 4
              against 4 single calls (one state, one generator seed, cuDNN
              deterministic) for M5 and CnnAvgPooling: equal; resume at step
              10 equal to the uninterrupted run; ``profile_dir`` with
              steps_per_call 4: one trace of steps 12-20 holding
              ``train_step/forward`` and ``/backward``;
              ``make_batch_predictor`` and ``make_batch_evaluator`` called
              again after ``model.train()`` score as in eval mode, leave the
              running statistics alone, and a train step runs after them (P2);
              both TF32 flags off inside each call and the caller's after it
              (P3); ``python -m sed_tpu_torch.cli.main --no_plot`` with its
              defaults (Waveform, M5) on 4 of the files for 4 steps (run
              beside the untimed checks), its checkpoint scored by ``python -m
              sed_tpu_torch.cli.infer --arch M5`` against the in-process
              scores; times: M5's step with augmentation off and on (and once
              with cuDNN's benchmark mode), its split by profiler range and
              the kernels' share, the step with steps_per_call 1 and 4 for M5,
              CnnAvgPooling and MobileNetV1, im/sec, evaluate ms a recording,
              peak memory.

 13. serve    sed_tpu's checkpoints and the live serving of MobileNetV1 and M5,
              at full width with seeded weights and BatchNorm statistics:
              for each arch a port ``iteration_7.pt`` through ``python -m
              sed_tpu_torch.cli.export_torch`` (a reference ``.pth``) and
              ``cli.import_torch`` (``iteration_7.pt`` again), every weight
              bit-equal; ``load_model_and_state`` of the ``.pth`` and of the
              imported ``.pt`` on the card scores phase 10's 2-minute WAV as
              the original weights (one K1 and one K2 a spectrogram file,
              counts reset just before, read just after), and so does ``cli.infer
              --no_plot`` of the imported file; MobileNetV1 (its logits view,
              halo 88) in a 32-slot ``StreamPool`` on phase 5's run (uneven
              pieces, late joins, an early leaver), every stream against
              ``make_batch_predictor``, K3 and K2 on its ticks, and again with
              ``featurizer="xla"`` (no launch); M5 in
              ``DeviceWaveformStreamPool`` and ``WaveformStreamPool`` on the
              same run with one mulaw stream and a 20 s backlog (blocks of 16
              rounds), every stream against offline framing, the two pools
              against each other, no K1–K10 launch; ``cli.stream --arch
              MobileNetV1`` and ``--arch M5`` (both ``--m5_pool``) on three
              WAVs; ``StreamServer`` over a MobileNetV1 pool and an M5 device
              pool, two pcm16 clients and one mulaw client each, against
              offline scoring; times: MobileNetV1's tick and M5's device
              round at 32 slots (CUDA events), each pool's feed + tick by the
              host clock, the device time of both by kernel
              (``torch.profiler``), audio-s per wall-s and peak memory of the
              three pool runs.

Then one ``{"kernels": [...]}`` JSON line (K1–K10; K1's and K2's with the
training path's launches, every entry with phase 12's, 0, and phase 13's),
the ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import dataclasses
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
TRAIN_FILES, TRAIN_SECONDS = 32, 60.0   # phase 11 corpus: FilmClap layout, 48 kHz mono
TRAIN_COMPLEX_FILES = 8   # of them, also preprocessed in Complex mode
TRAIN_BATCH = 128         # cli/main.py's batch (crop: cfg.train_crop_size, 30 frames)
TRAIN_STEPS, TRAIN_LR = 400, 3e-3   # tests/test_loop.py's learning rate
CPU_STEPS = 5             # card against CPU
RESUME_AT, RESUME_STEPS = 10, 20
FEW_STEPS = 10            # Complex + augmentation, MobileNetV1
EVAL_CLIPS = 4            # make_batch_evaluator: 4 x 60 s int16 clips
TRAIN_REL_TOL = 1e-4      # card against CPU: losses (relative), gradients (x largest |grad|)
TRAIN_PROFILE_STEPS = 5
WAVE_BATCH = 128          # cli/main.py's batch: 128 crops of 31,680 samples (M5)
WAVE_CPU_BATCH = 32       # M5 card against CPU in float64 (cut from 128: the CPU's time)
WAVE_VAL = 0.25           # validation share of phase 11's corpus (8 of 32 files)
WAVE_CLI_FILES = 4        # the training CLI's run: a subset of the corpus
CONV_BIASES = (".0.bias", ".3.bias")   # M5's conv biases, each removed by a BatchNorm
STEPS_PER_CALL = 4
SERVE_ARCHS = ("CnnAvgPooling", "MobileNetV1", "M5")
SERVE_STEP = 7            # the step the converted checkpoints carry
SERVE_MULAW = 4           # the M5 pools' mulaw stream
SERVE_BACKLOG = (3, 20 * 48000)   # M5 stream 3's first piece: 20 s, more than 16 rounds
SERVE_STREAM_RUNS = (("MobileNetV1", []), ("M5", ["--m5_pool", "device"]),
                     ("M5", ["--m5_pool", "host"]))
JSONL_KEYS = {"iteration", "train_loss", "val_loss", "AP", "max_f1", "max_f5", "event_tp",
              "event_fp", "event_fn", "event_precision", "event_recall", "event_f1",
              "segment_tp", "segment_fp", "segment_fn", "segment_precision", "segment_recall",
              "segment_f1", "segment_substitutions", "segment_deletions", "segment_insertions",
              "segment_n_ref", "segment_error_rate", "AP_per_class", "macro_AP",
              "event_macro_precision", "event_macro_recall", "event_macro_f1",
              "segment_macro_precision", "segment_macro_recall", "segment_macro_f1"}
REPS = 20
QUEUED = 20         # calls in a row between one pair of events (time_ms's calls)

# The launch counters (``cuda_featurizer.LAUNCHES``) of each entry of the
# kernels line.
ENTRY_COUNTERS = {
    "wave_stft_power": ("wave_stft_power",), "mel_log": ("mel_log",),
    "frames_stft_power": ("frames_stft_power",), "power_to_logmel_cuda": ("mel_log",),
    "wave_stft_mel_log": ("wave_stft_mel_log",), "wave_packed_fft": ("wave_packed_fft",),
    "stft_eo_power_from_waveform": ("wave_stft_power",),
    "stft_power_from_waveform_raw": ("wave_stft_power",),
    "logmel_waveform_rolledge": ("wave_stft_power", "mel_log"),
    "stft_power_from_waveform(slice, roll_nodb)": ("wave_stft_power",),
}

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


_cli_runs = []


def start_cli(args, log_path):
    """Start ``python -m <args>`` from the repository root in the background,
    its output to ``log_path``; ``finish_cli`` waits for it."""
    with open(log_path, "w") as f:
        proc = subprocess.Popen([sys.executable, "-m", *map(str, args)], cwd=REPO,
                                stdout=f, stderr=subprocess.STDOUT)
    _cli_runs.append(proc)
    return proc


def finish_cli(proc, log_path, what: str) -> None:
    proc.wait(timeout=600)
    if proc.returncode != 0:
        print(Path(log_path).read_text()[-4000:], file=sys.stderr)
    check(proc.returncode == 0, f"{what} exit code {proc.returncode}")


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


def stop_background() -> None:
    """Stop what the script started and has not waited for: lesion builds
    and CLI runs."""
    for proc in [proc for _, proc, _, _ in _lesion_builds] + _cli_runs:
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


def drive_pool(torch, dev, pool, clips, chunk, seed, backlog=None):
    """Phase 5's run of a pool: every clip a stream, fed in pieces of 0.4 to
    1.6 chunks a tick (stream ``backlog[0]``'s first piece ``backlog[1]``
    samples), the streams of ``LATE_JOINS`` joining late, each stream leaving
    through ``leave_many`` when its audio ends.  The launch counts and the
    peak memory are reset just before and read just after.  Returns (each
    stream's scores, wall seconds, launches, peak MiB, ticks)."""
    from sed_tpu_torch.ops import cuda_featurizer as kernels

    rng = np.random.default_rng(seed)
    recs = [{"wav": c, "pos": 0, "blocks": []} for c in clips]
    waiting = list(range(len(clips)))
    active, tick = {}, 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    while waiting or active:
        for i in [i for i in waiting if LATE_JOINS.get(i, 0) <= tick]:
            active[pool.join()] = recs[i]
            waiting.remove(i)
        leaving = []
        for slot, rec in active.items():
            n = int(chunk * rng.uniform(0.4, 1.6))
            if backlog and rec is recs[backlog[0]] and rec["pos"] == 0:
                n = backlog[1]
            piece = rec["wav"][rec["pos"]: rec["pos"] + n]
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
    wall = time.perf_counter() - t0
    return ([np.concatenate(r["blocks"]) for r in recs], wall, dict(kernels.LAUNCHES),
            torch.cuda.max_memory_allocated(dev) / 2**20, tick)


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


def film_clap_corpus(root, files, seconds, sr, seed):
    """A FilmClap-layout corpus (io/film_clap.py): ``files`` mono int16 WAVs
    of noise with tonal bursts as the labelled events, and the label JSON
    beside them.  FilmClap labels are event centres, each event spanning
    +-time_margin (0.33 s); a burst of 3-5 s is labelled by centres 0.33 s
    apart along it, whose intervals join into one event of the burst's
    length (long enough for the model's 8-frame output steps).  One burst
    per 15 s.  Returns the WAV paths."""
    import json as _json

    from scipy.io import wavfile

    from sed_tpu_torch.configs import DEFAULT_SPECTROGRAM
    from sed_tpu_torch.io.film_clap import LABEL_FILE

    half = DEFAULT_SPECTROGRAM.time_margin
    film_dir = root / "FilmClap" / "film"
    film_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    slot = 15.0
    labels, paths = {}, []
    for i in range(files):
        x = 0.05 * rng.standard_normal(n)
        x += 0.03 * np.sin(2 * np.pi * rng.uniform(200, 6000) * np.arange(n) / sr)
        centers = []
        for j in range(max(1, int(seconds // slot))):
            length = rng.uniform(3.0, 5.0)
            start = j * slot + rng.uniform(1.0, slot - length - 1.0)
            a, b = int(start * sr), int((start + length) * sr)
            t = np.arange(b - a) / sr
            x[a:b] += 0.3 * (np.sin(2 * np.pi * 2000.0 * t) + np.sin(2 * np.pi * 3100.0 * t))
            centers += list(np.arange(start + half, start + length - half + 1e-9, half))
        path = str(film_dir / f"clip_{i:02d}.wav")
        wavfile.write(path, sr, (np.clip(x, -1, 1) * 32767).astype(np.int16))
        labels[path] = [float(c) for c in centers]
        paths.append(path)
    with open(root / "FilmClap" / LABEL_FILE, "w") as f:
        _json.dump(labels, f)
    return paths


def subset_corpus(root, paths, source_root):
    """A FilmClap root whose label file lists ``paths`` of ``source_root``'s."""
    import json as _json

    from sed_tpu_torch.io.film_clap import LABEL_FILE

    with open(source_root / "FilmClap" / LABEL_FILE) as f:
        labels = _json.load(f)
    (root / "FilmClap").mkdir(parents=True, exist_ok=True)
    with open(root / "FilmClap" / LABEL_FILE, "w") as f:
        _json.dump({p: labels[p] for p in paths}, f)


def profile_parts(torch, fn, n: int):
    """``torch.profiler`` over ``n`` calls of ``fn``: (device ms per call of
    the kernels each ``train_step/...`` range launched on the calling
    thread, [(kernel, ms per call), ...] largest first).  Both empty when
    the profiler captured no device time.  The ranges' own device-side
    annotations are not kernels and are left out of the list."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    parts = {}
    for e in prof.events():
        if e.name.startswith("train_step/") and e.device_type == DeviceType.CPU:
            parts[e.name] = parts.get(e.name, 0.0) + e.device_time_total / 1e3 / n
    kernels_ = sorted(((e.key, e.self_device_time_total / 1e3 / n) for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                       and not e.key.startswith("train_step/")), key=lambda r: -r[1])
    return {k: v for k, v in parts.items() if v > 0}, kernels_


def grad_err(a, b):
    """(largest of |a - b| / b's largest |grad| over the tensors, that tensor)."""
    return max((float((a[k] - g).abs().max() / g.abs().max().clamp_min(1e-300)), k)
               for k, g in b.items())


def train_phase(torch, cfg, dev, smi, tmp):
    """Phase 11: training of the spectrogram family (see the module
    docstring).  Returns the K1 and K2 launches of its path (the logMel
    preprocess and the batch evaluator), and the corpus (``tmp / "data"``:
    its WAVs, ``wavs``) and logMel dataset (``dataset``) for phase 12."""
    import contextlib
    import io
    import re

    from sed_tpu_torch.cli import infer
    from sed_tpu_torch.data import device_pipeline as pipe
    from sed_tpu_torch.data.events import create_event_matrix
    from sed_tpu_torch.data.preprocess import featurize_file
    from sed_tpu_torch.data.spectrogram_dataset import (SpectrogramDataset,
                                                        preprocess_film_clap_data)
    from sed_tpu_torch.inference import make_batch_evaluator, make_batch_predictor
    from sed_tpu_torch.models.cnn import TRAIN_CHANNEL_AND_POOL, CnnAvgPooling, MobileNetV1
    from sed_tpu_torch.ops import cuda_featurizer as kernels
    from sed_tpu_torch.train import checkpoint, loop
    from sed_tpu_torch.train.state import init_state

    t0 = time.perf_counter()
    sr = cfg.working_sample_rate
    # Model output frames of one file: 8 * floor(frames / 8).
    out_frames = 8 * ((1 + int(TRAIN_SECONDS * sr) // cfg.hop_size) // 8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    data = tmp / "data"
    wavs = film_clap_corpus(data, TRAIN_FILES, TRAIN_SECONDS, sr, 30)
    log(f"[train] {TRAIN_FILES} x {TRAIN_SECONDS:.0f} s WAVs written (FilmClap layout, a 3-5 s "
        f"tonal burst per 15 s); {time.perf_counter() - t0:.1f} s")

    # ---- preprocess: logMel (K1 + K2 once a file), Complex on a subset ----
    launches = {}
    pre_t = {}
    kernels.reset_launch_counts()
    t1 = time.perf_counter()
    features_dir, mean_std = preprocess_film_clap_data(str(data), "logMel", cfg=cfg,
                                                       device=DEVICE, plot_sample=False)
    pre_s = time.perf_counter() - t1
    launches["preprocess"] = {k: kernels.LAUNCHES[k] for k in ("wave_stft_power", "mel_log")}
    log(f"[train] preprocess logMel: {TRAIN_FILES} files in {pre_s:.2f} s; launches "
        f"{launches['preprocess']}")
    for k in ("wave_stft_power", "mel_log"):
        check(launches["preprocess"][k] == TRAIN_FILES,
              f"{k} launched once per preprocessed file ({launches['preprocess'][k]})")
    pre_t = {}
    for path in wavs[:4]:   # the read / featurize split, timed apart
        featurize_file(path, cfg, "logMel", device=DEVICE, timings=pre_t)
    with open(Path(features_dir) / "film_clip_00_logMel_features_and_labels.pkl", "rb") as f:
        card_feats = pickle.load(f)["features"]
    cpu_feats = featurize_file(wavs[0], cfg, "logMel", device="cpu")
    pre_db = float(np.abs(card_feats - cpu_feats).max())
    log(f"[train] preprocessed log-mel, card against device='cpu' (one file, "
        f"{card_feats.shape}): {pre_db:.3e} dB (tol {DB_TOL})")
    check(pre_db <= DB_TOL, "preprocessed features on the card within 1e-4 dB of the CPU's")

    cx_root = tmp / "data_complex"
    subset_corpus(cx_root, wavs[:TRAIN_COMPLEX_FILES], data)
    kernels.reset_launch_counts()
    t1 = time.perf_counter()
    cx_dir, cx_mean_std = preprocess_film_clap_data(str(cx_root), "Complex", cfg=cfg,
                                                    device=DEVICE, plot_sample=False)
    cx_s = time.perf_counter() - t1
    cx_launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
    log(f"[train] preprocess Complex: {TRAIN_COMPLEX_FILES} files in {cx_s:.2f} s; "
        f"launches {cx_launched}")
    check(not cx_launched, "Complex preprocessing launches no featurizer kernel")

    # ---- CnnAvgPooling(TRAIN_CHANNEL_AND_POOL), logMel, 400 steps ---------
    dataset = SpectrogramDataset(features_dir, mean_std, 0.25, preprocessed_mode="logMel",
                                 cfg=cfg, seed=0)
    n_val = len(dataset.val_feature_paths)
    model = CnnAvgPooling(cfg.classes_num, TRAIN_CHANNEL_AND_POOL)
    state = init_state(model, TRAIN_LR, dev, seed=0)
    init_sd = copy.deepcopy({k: v.cpu() for k, v in state.model.state_dict().items()})
    out_dir = tmp / "run_cnn"

    def eval_all(st):
        res = loop.evaluate(st.model, st, dataset, "spectogram", 5.0, str(out_dir), 0,
                            make_plots=False, cfg=cfg)
        return float(np.mean(res[0])), float(np.mean(res[3]))

    loss0, ap0 = eval_all(state)
    kernels.reset_launch_counts()
    printed = io.StringIO()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        state = loop.train(model, dataset, "spectogram", num_steps=TRAIN_STEPS, lr=TRAIN_LR,
                           log_freq=TRAIN_STEPS // 2, outputs_dir=str(out_dir),
                           batch_size=TRAIN_BATCH, cfg=cfg, initial_state=state,
                           make_plots=False, device=DEVICE)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t1
    launches["train"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
    t1 = time.perf_counter()
    loss1, ap1 = eval_all(state)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t1) / n_val * 1e3
    im_sec = [float(x) for x in re.findall(r"im/sec: ([0-9.]+)", printed.getvalue())]
    records = [json.loads(line) for line in open(out_dir / "metrics.jsonl")]
    log(f"[train] CnnAvgPooling(TRAIN_CHANNEL_AND_POOL) logMel, batch {TRAIN_BATCH}, "
        f"{len(dataset)} starts, {n_val} validation recordings: {TRAIN_STEPS} steps at lr "
        f"{TRAIN_LR} in {train_s:.2f} s (with {len(records)} evaluations); val loss "
        f"{loss0:.4f} -> {loss1:.4f}, AP {ap0:.4f} -> {ap1:.4f}; im/sec as train prints it "
        f"{im_sec}; launches during training {launches['train']}")
    check(loss1 < loss0, f"validation loss falls ({loss0:.4f} -> {loss1:.4f})")
    check(ap1 > max(ap0, 0.5), f"AP {ap1:.4f} > max(AP0 {ap0:.4f}, 0.5)")
    check(len(records) == 2 and set(records[0]) == JSONL_KEYS,
          f"metrics.jsonl records with sed_tpu's keys ({sorted(set(records[0]) ^ JSONL_KEYS)})")
    check(not launches["train"], "training launches no featurizer kernel")
    check({p.name for p in (out_dir / "checkpoints").iterdir()} ==
          {f"iteration_{TRAIN_STEPS // 2}.pt", f"iteration_{TRAIN_STEPS}.pt"},
          "train() writes a checkpoint each log point")

    # ---- card against CPU: the same state, batches, no augmentation -------
    # In float64 for the 5 steps.  In float32 the card's first gradients part
    # from float64 by ~4e-3 of a tensor's largest (at block 3's second
    # BatchNorm bias, a sum over 14,336 terms a channel, whose backward the
    # card sums in float32), where the CPU's, which sums float32 in float64,
    # stay within ~6e-6; Adam's sign-like first update carries that into
    # later losses.  In float32 the first loss is compared, and the first
    # gradients reported with the tensor where they differ most.
    batches = list(dataset.epoch_start_indices(TRAIN_BATCH))
    step = pipe.make_spectrogram_train_step(cfg, 5.0, "logMel", augment=False)

    def run(where, dtype, n):
        m = CnnAvgPooling(cfg.classes_num, TRAIN_CHANNEL_AND_POOL)
        m.load_state_dict(init_sd)
        st = init_state(m.to(dtype), TRAIN_LR, where)
        bufs = pipe.spectrogram_buffers_from_dataset(dataset, where)
        bufs = dataclasses.replace(bufs, features=bufs.features.to(dtype),
                                   events=bufs.events.to(dtype), mean=bufs.mean.to(dtype),
                                   std=bufs.std.to(dtype))
        losses, grads = [], None
        for i in range(n):
            losses.append(float(step(st, bufs, batches[i])))
            if i == 0:
                grads = {k: p.grad.detach().cpu().double()
                         for k, p in st.model.named_parameters()}
        return losses, grads

    t1 = time.perf_counter()
    cpu64, cpu64_g = run("cpu", torch.float64, CPU_STEPS)
    card64, card64_g = run(DEVICE, torch.float64, CPU_STEPS)
    cpu32, cpu32_g = run("cpu", torch.float32, 1)
    card32, card32_g = run(DEVICE, torch.float32, 1)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card64, cpu64))
    grad_rel = grad_err(card64_g, cpu64_g)[0]
    loss32_rel = abs(card32[0] - cpu32[0]) / abs(cpu32[0])
    log(f"[train] card against CPU from one state, float64, {CPU_STEPS} steps: losses {card64} "
        f"vs {cpu64}, max rel err {loss_rel:.3e}; first gradients max err / tensor's largest "
        f"|grad| {grad_rel:.3e} (tol {TRAIN_REL_TOL}); {time.perf_counter() - t1:.1f} s")
    log(f"[train] card against CPU, float32, first step: loss {card32[0]} vs {cpu32[0]} (rel err "
        f"{loss32_rel:.3e}, tol {TRAIN_REL_TOL}); gradients max err / tensor's largest |grad| "
        f"(the tensor): card against CPU %.3e (%s), card against float64 %.3e (%s), CPU "
        f"against float64 %.3e (%s)" % (*grad_err(card32_g, cpu32_g), *grad_err(card32_g, cpu64_g),
                                        *grad_err(cpu32_g, cpu64_g)))
    check(loss_rel <= TRAIN_REL_TOL, "card losses within 1e-4 relative of the CPU's (float64)")
    check(grad_rel <= TRAIN_REL_TOL, "card gradients within 1e-4 of the CPU's (float64)")
    check(loss32_rel <= TRAIN_REL_TOL, "card's first float32 loss within 1e-4 of the CPU's")

    # ---- resume: save at step S, load, continue == uninterrupted ----------
    bufs = pipe.spectrogram_buffers_from_dataset(dataset, dev)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        def fresh(seed=None):
            m = CnnAvgPooling(cfg.classes_num, TRAIN_CHANNEL_AND_POOL)
            m.load_state_dict(init_sd)
            return init_state(m, TRAIN_LR, dev, seed=seed)

        cont = fresh()
        cont_losses = [float(step(cont, bufs, batches[i])) for i in range(RESUME_STEPS)]
        first = fresh()
        for i in range(RESUME_AT):
            step(first, bufs, batches[i])
        ckpt = checkpoint.save_checkpoint(first, str(tmp / "run_resume"), RESUME_AT)
        resumed = checkpoint.load_checkpoint(ckpt, fresh(seed=99), model_only=False)
        res_losses = [float(step(resumed, bufs, batches[i]))
                      for i in range(RESUME_AT, RESUME_STEPS)]
    finally:
        torch.backends.cudnn.deterministic = deterministic
    res_loss_err = max(abs(a - b) for a, b in zip(res_losses, cont_losses[RESUME_AT:]))
    res_param_err = max(float((a - b).abs().max()) for a, b in
                        zip(cont.model.state_dict().values(), resumed.model.state_dict().values()))
    log(f"[train] resume at step {RESUME_AT} of {RESUME_STEPS} (cuDNN deterministic for both "
        f"runs): max loss err {res_loss_err:.3e}, max parameter / statistic err "
        f"{res_param_err:.3e} (tol 1e-6)")
    check(resumed.step == RESUME_STEPS and res_loss_err <= 1e-6 and res_param_err <= 1e-6,
          "resumed training equals the uninterrupted run")
    scorer = infer.load_model(ckpt, cfg.classes_num, "CnnAvgPooling")
    _, scores = infer.predict_file(scorer, wavs[-1], cfg, dataset.mean, dataset.std,
                                   device=DEVICE)
    check(scores.shape == (out_frames, cfg.classes_num) and np.isfinite(scores).all(),
          f"iteration_{RESUME_AT}.pt scores a WAV through cli/infer.load_model")
    log(f"[train] iteration_{RESUME_AT}.pt loads into cli/infer.load_model and scores "
        f"{Path(wavs[-1]).name}: {scores.shape}")
    del bufs, cont, first, resumed

    # ---- Complex mode with augmentation -----------------------------------
    cx_data = SpectrogramDataset(cx_dir, cx_mean_std, 0.25, augment_data=True,
                                 preprocessed_mode="Complex", cfg=cfg, seed=0)
    cx_printed = io.StringIO()
    with contextlib.redirect_stdout(cx_printed):
        cx_state = loop.train(CnnAvgPooling(cfg.classes_num, TRAIN_CHANNEL_AND_POOL), cx_data,
                              "spectogram", num_steps=FEW_STEPS, lr=TRAIN_LR,
                              log_freq=FEW_STEPS, outputs_dir=str(tmp / "run_complex"),
                              batch_size=TRAIN_BATCH, augment=True, preprocessed_mode="Complex",
                              cfg=cfg, make_plots=False, device=DEVICE)
    cx_rec = json.loads(open(tmp / "run_complex" / "metrics.jsonl").read().splitlines()[-1])
    cx_bufs = pipe.spectrogram_buffers_from_dataset(cx_data, dev)
    cx_starts = torch.as_tensor(cx_data.train_start_indices[:16], device=dev)
    f, _ = pipe.make_gather_crops(cfg)(cx_bufs, cx_starts)
    transform = pipe.make_transform(cfg, "Complex")
    with torch.no_grad():
        card_x = transform(cx_bufs, f).cpu()
        cpu_bufs = pipe.spectrogram_buffers_from_dataset(cx_data, "cpu")
        cpu_x = transform(cpu_bufs, f.cpu())
    cx_db = float((card_x - cpu_x).abs().max())
    log(f"[train] Complex + augmentation: {FEW_STEPS} steps, last train loss "
        f"{cx_rec['train_loss']:.4f}, val loss {cx_rec['val_loss']:.4f}; the transform's "
        f"log-mel of 16 crops, card against CPU: {cx_db:.3e} dB (tol {DB_TOL})")
    check(np.isfinite(cx_rec["train_loss"]) and np.isfinite(cx_rec["val_loss"]),
          "Complex-mode training losses are finite")
    check(cx_db <= DB_TOL, "Complex transform on the card within 1e-4 dB of the CPU's")
    del cx_bufs, cpu_bufs, f, cx_state

    # ---- MobileNetV1 (emit='logits') --------------------------------------
    mn_printed = io.StringIO()
    with contextlib.redirect_stdout(mn_printed):
        mn_state = loop.train(MobileNetV1(cfg.classes_num, emit="logits"), dataset, "spectogram",
                              num_steps=FEW_STEPS, lr=TRAIN_LR, log_freq=FEW_STEPS,
                              outputs_dir=str(tmp / "run_mobilenet"), batch_size=TRAIN_BATCH,
                              cfg=cfg, make_plots=False, device=DEVICE)
    mn_rec = json.loads(open(tmp / "run_mobilenet" / "metrics.jsonl").read().splitlines()[-1])
    mn_ckpt = tmp / "run_mobilenet" / "checkpoints" / f"iteration_{FEW_STEPS}.pt"
    mn_loaded = infer.load_model(str(mn_ckpt), cfg.classes_num, "MobileNetV1")
    check(torch.equal(mn_loaded.fc1.weight, mn_state.model.fc1.weight.cpu()),
          "the MobileNetV1 checkpoint loads into load_model(arch='MobileNetV1')")
    log(f"[train] MobileNetV1 (emit='logits'): {FEW_STEPS} steps and one evaluation, train "
        f"loss {mn_rec['train_loss']:.4f}, val loss {mn_rec['val_loss']:.4f}, AP "
        f"{mn_rec['AP']:.4f}; iteration_{FEW_STEPS}.pt loads into load_model(arch='MobileNetV1')")
    check(np.isfinite(mn_rec["train_loss"]) and np.isfinite(mn_rec["val_loss"]),
          "MobileNetV1 training losses are finite")

    # ---- make_batch_evaluator on 4 x 60 s int16 clips ---------------------
    from scipy.io import wavfile

    clips = np.stack([wavfile.read(p)[1] for p in wavs[:EVAL_CLIPS]])[..., None]
    with open(data / "FilmClap" / "paths_and_labels_fixed_Meron.txt") as f:
        centers = json.load(f)
    targets = np.stack([create_event_matrix(
        out_frames, np.array(centers[p]) - cfg.time_margin, np.array(centers[p]) + cfg.time_margin,
        cfg) for p in wavs[:EVAL_CLIPS]])
    evaluate = make_batch_evaluator(state.model, cfg, dataset.mean, dataset.std, device=DEVICE)
    predict = make_batch_predictor(state.model, cfg, dataset.mean, dataset.std, device=DEVICE)
    clips_dev = torch.from_numpy(clips).to(dev)
    kernels.reset_launch_counts()
    ev_scores, ev_losses, _, _, ev_aps = evaluate(clips_dev, targets)
    torch.cuda.synchronize()
    launches["evaluator"] = {k: kernels.LAUNCHES[k] for k in ("wave_stft_power", "mel_log")}
    ev_err = float((ev_scores - predict(clips_dev)[:, :out_frames]).abs().max())
    log(f"[train] make_batch_evaluator on {EVAL_CLIPS} x {TRAIN_SECONDS:.0f} s int16 clips: "
        f"scores against make_batch_predictor {ev_err:.3e} (tol {SCORE_TOL}); losses "
        f"{[round(float(v), 4) for v in ev_losses]}, APs {[round(float(v), 4) for v in ev_aps]}; "
        f"launches {launches['evaluator']}")
    check(ev_err <= SCORE_TOL, "batch evaluator scores equal the batch predictor's")
    check(launches["evaluator"] == {"wave_stft_power": 1, "mel_log": 1},
          "one K1 and one K2 launch per make_batch_evaluator call")

    # ---- times -------------------------------------------------------------
    log(f"[times] phase 11 on {smi}; each line's card is this one:")
    log(f"[times] preprocess (logMel, {TRAIN_SECONDS:.0f} s files, mean of 4): read (scipy decode, mono) "
        f"{pre_t['read'] / 4 * 1e3:.2f} ms | featurize (float32 cast, upload, K1 + K2, "
        f"download) {pre_t['featurize'] / 4 * 1e3:.2f} ms per file; whole job "
        f"{pre_s / TRAIN_FILES * 1e3:.2f} ms per file logMel, {cx_s / TRAIN_COMPLEX_FILES * 1e3:.2f}"
        f" ms Complex; {smi}")
    log(f"[times] evaluate (bucketed exact forward, host metrics): {eval_ms:.2f} ms per "
        f"{TRAIN_SECONDS:.0f} s validation recording; train() im/sec {im_sec} "
        f"(the reference's definition: steps x batch / wall-s since the start, evaluations "
        f"included; {smi})")
    step_ms, parts, top = {}, {}, []
    cx_bufs = pipe.spectrogram_buffers_from_dataset(cx_data, dev)
    lm_bufs = pipe.spectrogram_buffers_from_dataset(dataset, dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    for arch in ("CnnAvgPooling", "MobileNetV1"):
        for mode, bufs, data_ in (("logMel", lm_bufs, dataset), ("Complex", cx_bufs, cx_data)):
            for aug in (False, True):
                m = (CnnAvgPooling(cfg.classes_num, TRAIN_CHANNEL_AND_POOL) if arch == "CnnAvgPooling"
                     else MobileNetV1(cfg.classes_num, emit="logits"))
                st = init_state(m, TRAIN_LR, dev, seed=1)
                fn_step = pipe.make_spectrogram_train_step(cfg, 5.0, mode, augment=aug)
                starts = torch.as_tensor(data_.train_start_indices[:TRAIN_BATCH], device=dev)
                step_ms[arch, mode, aug] = time_ms(
                    torch, lambda: fn_step(st, bufs, starts, gen))
                if arch == "CnnAvgPooling" and mode == "logMel" and not aug:
                    parts, top = profile_parts(torch, lambda: fn_step(st, bufs, starts, gen),
                                               TRAIN_PROFILE_STEPS)
    for (arch, mode, aug), ms in step_ms.items():
        log(f"[times] train step {arch} {mode} augmentation {'on' if aug else 'off'}, batch "
            f"{TRAIN_BATCH} x {cfg.train_crop_size} frames: {ms:.4f} ms (CUDA-event median of "
            f"{REPS}; {TRAIN_BATCH / ms * 1e3:.1f} im/sec; {smi})")
    if parts and top:
        part = {k.split("/")[1]: v for k, v in parts.items()}
        busy = sum(ms for _, ms in top)
        # The autograd engine runs the backward on its own thread, outside
        # the train_step/backward range: its kernels are the rest of the step's.
        part["backward"] = busy - sum(v for k, v in part.items() if k != "backward")
        log(f"[times] CnnAvgPooling logMel step by part (torch.profiler, "
            f"{TRAIN_PROFILE_STEPS} steps, device ms per step, {smi}; backward = the kernels outside "
            f"the other ranges): gather + transform "
            f"{part.get('gather', 0.0) + part.get('transform', 0.0):.4f}, forward + backward "
            f"{part.get('forward', 0.0) + part['backward']:.4f}, optimizer "
            f"{part.get('optimizer', 0.0):.4f} (" + ", ".join(
                f"{k} {v:.4f}" for k, v in sorted(part.items(), key=lambda r: -r[1])) + ")")
        log(f"[times] its kernels: {busy:.4f} ms a step "
            f"({busy / step_ms['CnnAvgPooling', 'logMel', False]:.1%} of the step); the 8 largest:")
        for kname, ms in top[:8]:
            log(f"[times]   {ms:.4f} ms  {kname[:90]}")
    else:
        log("[times] step by part: torch.profiler captured no device time (not measured)")
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    log(f"[times] phase 11 peak device memory {peak:.1f} MiB ({smi})")
    log(f"[train] phase {time.perf_counter() - t0:.1f} s")
    return ({k: launches["preprocess"][k] + launches["evaluator"][k]
             for k in ("wave_stft_power", "mel_log")}, {"wavs": wavs, "dataset": dataset})


def trace_names(path):
    """The event names of a Chrome trace file."""
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def wavetrain_phase(torch, cfg, dev, smi, tmp, spec):
    """Phase 12: M5 training on the card (see the module docstring), on
    phase 11's corpus under ``tmp`` (``spec``: its WAVs and logMel dataset).
    Returns the launch counts of every kernel wrapper while M5 trained."""
    import contextlib
    import io
    import itertools
    import re

    from scipy.io import wavfile

    from sed_tpu_torch.cli import infer
    from sed_tpu_torch.configs import WaveformConfig
    from sed_tpu_torch.data import device_pipeline as pipe
    from sed_tpu_torch.data.waveform_dataset import WaveformDataset
    from sed_tpu_torch.inference import make_batch_evaluator, make_batch_predictor
    from sed_tpu_torch.io.film_clap import get_film_clap_paths_and_labels
    from sed_tpu_torch.models.cnn import TRAIN_CHANNEL_AND_POOL, CnnAvgPooling, MobileNetV1
    from sed_tpu_torch.models.m5 import M5
    from sed_tpu_torch.ops import cuda_featurizer as kernels
    from sed_tpu_torch.train import checkpoint, loop
    from sed_tpu_torch.train.state import init_state

    t0 = time.perf_counter()
    wcfg = WaveformConfig()
    data, wavs = tmp / "data", spec["wavs"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    # ---- the dataset and its buffers (one upload) --------------------------
    quiet = io.StringIO()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(quiet):
        dataset = WaveformDataset(get_film_clap_paths_and_labels(str(data / "FilmClap"),
                                                                 wcfg.time_margin),
                                  WAVE_VAL, cfg=wcfg, seed=0)
    ds_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    bufs = pipe.waveform_buffers_from_dataset(dataset, dev)
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t1
    n_val, total = len(dataset.val_file_names), dataset.long_waveform.shape[1]
    up_mib = sum(t.numel() * t.element_size() for t in (bufs.waveform, bufs.labels,
                                                         bufs.start_indices)) / 2**20
    check(bufs.waveform.shape == (1, total) and bufs.waveform.dtype == torch.float32
          and bufs.labels.shape == (total,) and bufs.labels.dtype == torch.float32
          and bufs.start_indices.dtype == torch.int64 and bufs.waveform.device == dev,
          "waveform buffers on the card: samples and labels float32, starts int64")
    check(torch.equal(bufs.waveform[0, -wcfg.frame_size:].cpu(),
                      torch.from_numpy(dataset.long_waveform[0, -wcfg.frame_size:]))
          and torch.equal(bufs.start_indices[:1000].cpu(), torch.from_numpy(
              dataset.possible_start_indices[:1000]).long()),
          "the uploaded buffers equal the dataset's arrays")
    log(f"[wavetrain] WaveformDataset on phase 11's corpus: {total} samples of "
        f"{len(wavs) - n_val} files, {len(dataset)} starts, {n_val} validation recordings "
        f"in {ds_s:.2f} s; one upload ({up_mib:.1f} MiB) in {up_s:.2f} s")

    # ---- M5(1), 400 steps at batch 128 ---------------------------------------
    model = M5(wcfg.classes_num)
    state = init_state(model, TRAIN_LR, dev, seed=0)
    init_sd = copy.deepcopy({k: v.cpu() for k, v in state.model.state_dict().items()})
    out_dir = tmp / "run_m5"

    def eval_all(st):
        res = loop.evaluate(st.model, st, dataset, "waveform", 5.0, str(out_dir), 0,
                            make_plots=False, cfg=wcfg)
        return float(np.mean(res[0])), float(np.mean(res[3]))

    loss0, ap0 = eval_all(state)
    kernels.reset_launch_counts()
    printed = io.StringIO()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        state = loop.train(model, dataset, "waveform", num_steps=TRAIN_STEPS, lr=TRAIN_LR,
                           log_freq=TRAIN_STEPS // 2, outputs_dir=str(out_dir),
                           batch_size=WAVE_BATCH, cfg=wcfg, initial_state=state,
                           make_plots=False, device=DEVICE)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t1
    launches = dict(kernels.LAUNCHES)
    t1 = time.perf_counter()
    loss1, ap1 = eval_all(state)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t1) / n_val * 1e3
    im_sec = [float(x) for x in re.findall(r"im/sec: ([0-9.]+)", printed.getvalue())]
    records = [json.loads(line) for line in open(out_dir / "metrics.jsonl")]
    log(f"[wavetrain] M5(1), batch {WAVE_BATCH} x {wcfg.frame_size} samples: {TRAIN_STEPS} steps "
        f"at lr {TRAIN_LR} in {train_s:.2f} s (with {len(records)} evaluations); val loss "
        f"{loss0:.4f} -> {loss1:.4f}, AP {ap0:.4f} -> {ap1:.4f}; im/sec as train prints it "
        f"{im_sec}; launches during training {launches}")
    check(loss1 < loss0, f"validation loss falls ({loss0:.4f} -> {loss1:.4f})")
    check(ap1 > max(ap0, 0.5), f"AP {ap1:.4f} > max(AP0 {ap0:.4f}, 0.5)")
    check(len(records) == 2 and set(records[0]) == JSONL_KEYS,
          f"metrics.jsonl records with sed_tpu's keys ({sorted(set(records[0]) ^ JSONL_KEYS)})")
    check(not any(launches.values()), "M5 training launches none of K1-K10")
    check({p.name for p in (out_dir / "checkpoints").iterdir()} ==
          {f"iteration_{TRAIN_STEPS // 2}.pt", f"iteration_{TRAIN_STEPS}.pt"},
          "train() writes a checkpoint each log point")
    del state

    # The training CLI with its defaults (Waveform, M5, batch 128) on a few
    # of the files runs beside the checks below, none of which is timed.
    cli_root, cli_log = tmp / "data_cli", tmp / "cli_main.log"
    subset_corpus(cli_root, wavs[:WAVE_CLI_FILES], data)
    t_cli = time.perf_counter()
    cli_proc = start_cli(["sed_tpu_torch.cli.main", "--dataset_dir", cli_root, "--outputs_root",
                          tmp / "cli_runs", "--num_train_steps", 4, "--log_freq", 4, "--no_plot",
                          "--device", DEVICE], cli_log)

    # ---- card against CPU: one state, the same batches ---------------------
    # Float64 at batch WAVE_CPU_BATCH (the CPU's time); in float32 the first
    # loss is compared and the gradients' distances reported.  M5's conv
    # biases each feed a BatchNorm, which removes them: their gradients are
    # zero up to rounding, so they are left out of the gradient comparison
    # (their largest |grad| is printed).
    cpu_bufs = pipe.waveform_buffers_from_dataset(dataset, "cpu")
    step = pipe.make_waveform_train_step(wcfg, 5.0, augment=False)

    def as_dtype(b, dtype):
        return dataclasses.replace(b, waveform=b.waveform.to(dtype), labels=b.labels.to(dtype))

    def run(where, b, dtype, n):
        m = M5(wcfg.classes_num)
        m.load_state_dict(init_sd)
        st = init_state(m.to(dtype), TRAIN_LR, where)
        b = as_dtype(b, dtype)
        losses, grads = [], None
        for s in itertools.islice(dataset.epoch_start_indices(WAVE_CPU_BATCH), n):
            losses.append(float(step(st, b, s)))
            if grads is None:
                grads = {k: p.grad.detach().cpu().double() for k, p in st.model.named_parameters()}
        biases = max(float(g.abs().max()) for k, g in grads.items() if k.endswith(CONV_BIASES))
        return losses, {k: g for k, g in grads.items() if not k.endswith(CONV_BIASES)}, biases

    t1 = time.perf_counter()
    cpu64, cpu64_g, cpu64_b = run("cpu", cpu_bufs, torch.float64, CPU_STEPS)
    card64, card64_g, card64_b = run(DEVICE, bufs, torch.float64, CPU_STEPS)
    cpu32, cpu32_g, _ = run("cpu", cpu_bufs, torch.float32, 1)
    card32, card32_g, card32_b = run(DEVICE, bufs, torch.float32, 1)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card64, cpu64))
    grad_rel = grad_err(card64_g, cpu64_g)[0]
    loss32_rel = abs(card32[0] - cpu32[0]) / abs(cpu32[0])
    log(f"[wavetrain] card against CPU from one state, float64, batch {WAVE_CPU_BATCH}, "
        f"{CPU_STEPS} steps: losses {card64} vs {cpu64}, max rel err {loss_rel:.3e}; first "
        f"gradients max err / tensor's largest |grad| {grad_rel:.3e} (tol {TRAIN_REL_TOL}; "
        f"the conv biases' largest |grad|: card {card64_b:.3e}, CPU {cpu64_b:.3e}, card "
        f"float32 {card32_b:.3e}); {time.perf_counter() - t1:.1f} s")
    log(f"[wavetrain] card against CPU, float32, first step: loss {card32[0]} vs {cpu32[0]} "
        f"(rel err {loss32_rel:.3e}, tol {TRAIN_REL_TOL}); gradients max err / tensor's largest "
        f"|grad| (the tensor): card against CPU %.3e (%s), card against float64 %.3e (%s), CPU "
        f"against float64 %.3e (%s)" % (*grad_err(card32_g, cpu32_g), *grad_err(card32_g, cpu64_g),
                                        *grad_err(cpu32_g, cpu64_g)))
    check(loss_rel <= TRAIN_REL_TOL, "card losses within 1e-4 relative of the CPU's (float64)")
    check(grad_rel <= TRAIN_REL_TOL, "card gradients within 1e-4 of the CPU's (float64)")
    check(loss32_rel <= TRAIN_REL_TOL, "card's first float32 loss within 1e-4 of the CPU's")

    # ---- augmentation: a short run, and the apply card against CPU ---------
    aug_out = tmp / "run_m5_aug"
    with contextlib.redirect_stdout(io.StringIO()):
        loop.train(M5(wcfg.classes_num), dataset, "waveform", num_steps=FEW_STEPS, lr=TRAIN_LR,
                   log_freq=FEW_STEPS, outputs_dir=str(aug_out), batch_size=WAVE_BATCH,
                   augment=True, cfg=wcfg, make_plots=False, limit_val_samples=1,
                   device=DEVICE)
    aug_rec = json.loads(open(aug_out / "metrics.jsonl").read().splitlines()[-1])
    gather = pipe.make_waveform_gather(wcfg)
    starts = torch.as_tensor(dataset.possible_start_indices[:WAVE_BATCH], device=dev)
    w, y = gather(bufs, starts)
    d = pipe.draw_augmentation(torch.Generator(device=dev).manual_seed(3), bufs, w.shape, False)
    card_x, card_y = pipe.apply_augmentation(bufs, w, y, d, gather, False, pipe.WAVE_MIX_CUM)
    cpu_d = pipe.AugmentDraws(d.u_mix.cpu(), d.ptr.cpu(), d.u_noise.cpu(), d.noise.cpu())
    cpu_x, cpu_y = pipe.apply_augmentation(cpu_bufs, w.cpu(), y.cpu(), cpu_d, gather, False,
                                           pipe.WAVE_MIX_CUM)
    aug_err = float((card_x.cpu() - cpu_x).abs().max())
    log(f"[wavetrain] augmentation on: {FEW_STEPS} steps, last train loss "
        f"{aug_rec['train_loss']:.4f}, val loss {aug_rec['val_loss']:.4f}; the apply on one set "
        f"of {WAVE_BATCH} draws, card against CPU: {aug_err:.3e} (tol 1e-6), labels "
        f"{'equal' if torch.equal(card_y.cpu(), cpu_y) else 'differ'}")
    check(np.isfinite(aug_rec["train_loss"]) and np.isfinite(aug_rec["val_loss"]),
          "augmented M5 training losses are finite")
    check(aug_err <= 1e-6 and torch.equal(card_y.cpu(), cpu_y),
          "the augmentation apply on the card equals the CPU's")
    del cpu_bufs, w, y, d, card_x, cpu_x

    # ---- K steps in one call against K single calls, resume ----------------
    spec_data = spec["dataset"]
    spec_bufs = pipe.spectrogram_buffers_from_dataset(spec_data, dev)
    block = np.stack(list(itertools.islice(dataset.epoch_start_indices(WAVE_BATCH),
                                           STEPS_PER_CALL)))
    spec_block = np.stack(list(itertools.islice(spec_data.epoch_start_indices(TRAIN_BATCH),
                                                STEPS_PER_CALL)))
    families = {
        "M5": (lambda: M5(wcfg.classes_num), pipe.make_waveform_train_step(wcfg, 5.0, True),
               bufs, block),
        "CnnAvgPooling": (lambda: CnnAvgPooling(cfg.classes_num, TRAIN_CHANNEL_AND_POOL),
                          pipe.make_spectrogram_train_step(cfg, 5.0, "logMel", True),
                          spec_bufs, spec_block),
        "MobileNetV1": (lambda: MobileNetV1(cfg.classes_num, emit="logits"),
                        pipe.make_spectrogram_train_step(cfg, 5.0, "logMel", True),
                        spec_bufs, spec_block),
    }
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for arch in ("M5", "CnnAvgPooling"):
            fresh, fn_step, b, blk = families[arch]
            single = init_state(fresh(), TRAIN_LR, dev, seed=2)
            gen = torch.Generator(device=dev).manual_seed(11)
            want = torch.stack([fn_step(single, b, s, gen) for s in blk])
            multi = init_state(fresh(), TRAIN_LR, dev, seed=2)
            gen = torch.Generator(device=dev).manual_seed(11)
            got = pipe.make_multi_step(fn_step, STEPS_PER_CALL)(multi, b, blk, gen)
            p_err = max(float((u - v).abs().max()) for u, v in zip(
                single.model.state_dict().values(), multi.model.state_dict().values()))
            log(f"[wavetrain] make_multi_step, {arch}, K = {STEPS_PER_CALL} with augmentation "
                f"against {STEPS_PER_CALL} single calls (one state, one generator seed, cuDNN "
                f"deterministic): losses {got.tolist()} vs {want.tolist()}, max parameter / "
                f"statistic err {p_err:.3e}")
            check(torch.equal(got, want) and p_err == 0.0,
                  f"{arch}: K steps in one call equal K single calls")

        cont = init_state(M5(wcfg.classes_num), TRAIN_LR, dev, seed=0)
        batches = list(itertools.islice(dataset.epoch_start_indices(WAVE_BATCH), RESUME_STEPS))
        cont_losses = [float(step(cont, bufs, s)) for s in batches]
        first = init_state(M5(wcfg.classes_num), TRAIN_LR, dev, seed=0)
        for s in batches[:RESUME_AT]:
            step(first, bufs, s)
        ckpt = checkpoint.save_checkpoint(first, str(tmp / "run_m5_resume"), RESUME_AT)
        resumed = checkpoint.load_checkpoint(
            ckpt, init_state(M5(wcfg.classes_num), TRAIN_LR, dev, seed=99), model_only=False)
        res_losses = [float(step(resumed, bufs, s)) for s in batches[RESUME_AT:]]
    finally:
        torch.backends.cudnn.deterministic = deterministic
    res_loss_err = max(abs(a - b) for a, b in zip(res_losses, cont_losses[RESUME_AT:]))
    res_param_err = max(float((a - b).abs().max()) for a, b in
                        zip(cont.model.state_dict().values(), resumed.model.state_dict().values()))
    log(f"[wavetrain] resume at step {RESUME_AT} of {RESUME_STEPS} (cuDNN deterministic for both "
        f"runs): max loss err {res_loss_err:.3e}, max parameter / statistic err "
        f"{res_param_err:.3e} (tol 1e-6)")
    check(resumed.step == RESUME_STEPS and res_loss_err <= 1e-6 and res_param_err <= 1e-6,
          "resumed M5 training equals the uninterrupted run")
    del cont, first, resumed

    # ---- profile_dir: a trace of steps 12-20 in K-step calls ---------------
    prof_dir = tmp / "m5_profile"
    with contextlib.redirect_stdout(io.StringIO()):
        loop.train(M5(wcfg.classes_num), dataset, "waveform", num_steps=20, lr=TRAIN_LR,
                   log_freq=20, outputs_dir=str(tmp / "run_m5_profile"), batch_size=WAVE_BATCH,
                   cfg=wcfg, make_plots=False, limit_val_samples=1, profile_dir=str(prof_dir),
                   steps_per_call=STEPS_PER_CALL, device=DEVICE)
    traces = sorted(p.name for p in prof_dir.iterdir())
    names = trace_names(prof_dir / traces[0]) if traces else set()
    log(f"[wavetrain] profile_dir with steps_per_call {STEPS_PER_CALL}: {traces}, "
        f"{(prof_dir / traces[0]).stat().st_size / 2**20 if traces else 0:.1f} MiB, ranges "
        f"{sorted(n for n in names if str(n).startswith('train_step/'))}")
    check(traces == ["train_steps_12-20.json"]
          and {"train_step/forward", "train_step/backward"} <= names,
          "profile_dir holds a trace of steps 12-20 with the step's ranges")

    # ---- the predictor and the evaluator after model.train(); TF32 flags ---
    clips = np.stack([wavfile.read(p)[1] for p in wavs[:EVAL_CLIPS]])[..., None]
    clips_dev = torch.from_numpy(clips).to(dev)
    out_frames = 8 * ((1 + clips.shape[1] // cfg.hop_size) // 8)
    targets = torch.zeros(EVAL_CLIPS, out_frames, 1, device=dev)
    cnn = seed_batch_norms(torch, CnnAvgPooling(cfg.classes_num, TRAIN_CHANNEL_AND_POOL,
                                                generator=torch.Generator().manual_seed(4)), 4)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    seen, after = [], []
    hook = cnn.register_forward_hook(lambda *_: seen.append(
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        predict = make_batch_predictor(cnn, cfg, spec_data.mean, spec_data.std, device=DEVICE)
        evaluate = make_batch_evaluator(cnn, cfg, spec_data.mean, spec_data.std, device=DEVICE)
        calls = []
        for mode in ("eval", "train"):
            if mode == "train":
                stats = {k: v.clone() for k, v in cnn.state_dict().items() if "running" in k}
                cnn.train()
            calls.append((predict(clips_dev), evaluate(clips_dev, targets)[0]))
            after.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        stats_same = all(torch.equal(v, stats[k]) for k, v in cnn.state_dict().items()
                         if k in stats)
        p2_loss = float(pipe.make_spectrogram_train_step(cfg)(
            init_state(cnn, TRAIN_LR, dev), spec_bufs, spec_block[0]))
        after.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
    finally:
        hook.remove()
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    p2_err = max(float((a - b).abs().max()) for a, b in zip(calls[0], calls[1]))
    log(f"[wavetrain] P2: make_batch_predictor and make_batch_evaluator on {EVAL_CLIPS} x "
        f"{TRAIN_SECONDS:.0f} s "
        f"int16 clips, called again after model.train(): scores differ by {p2_err:.3e} "
        f"(tol 1e-6), running statistics {'unchanged' if stats_same else 'CHANGED'} (then "
        f"changed by the train step), a train step after them: loss {p2_loss:.4f}")
    log(f"[wavetrain] P3: TF32 flags (cuDNN, matmul) set True by the caller: inside the calls "
        f"{sorted(set(seen))}, after each call {after}")
    check(p2_err <= 1e-6, "the predictor and evaluator score in eval mode after model.train()")
    check(stats_same, "scoring after model.train() leaves the running statistics alone")
    check(np.isfinite(p2_loss), "a train step runs after the scoring calls")
    check(set(seen) == {(False, False)} and set(after) == {(True, True)},
          "TF32 off inside each call, the caller's flags after it")
    del predict, evaluate, cnn, calls

    # ---- the CLI's checkpoint scored by cli.infer --arch M5 ------------------
    finish_cli(cli_proc, cli_log, "cli.main (Waveform)")
    (cli_ckpt,) = (tmp / "cli_runs").glob("*/checkpoints/iteration_4.pt")
    cli_out = tmp / "cli_infer"
    run_cli(["sed_tpu_torch.cli.infer", "--arch", "M5", "--no_plot", "--ckpt", cli_ckpt,
             "--outputs_dir", cli_out, "--device", DEVICE, wavs[0]], "cli.infer --arch M5")
    cli_scores = np.load(cli_out / f"{Path(wavs[0]).stem}_scores.npy")
    ref = infer.predict_file_m5(infer.load_model(str(cli_ckpt), 1, "M5"), wavs[0], wcfg,
                                device=DEVICE)
    cli_err = float(np.abs(cli_scores - ref).max())
    log(f"[wavetrain] python -m sed_tpu_torch.cli.main --no_plot (defaults: Waveform, M5, batch "
        f"128) on {WAVE_CLI_FILES} files, 4 steps -> {cli_ckpt.relative_to(tmp)}; cli.infer "
        f"--arch M5 scores {Path(wavs[0]).name}: {cli_scores.shape}, against the in-process "
        f"predict_file_m5 {cli_err:.3e} (tol {SCORE_TOL}); {time.perf_counter() - t_cli:.1f} s "
        f"since the training CLI started")
    check(cli_scores.shape == ref.shape == (1 + (clips.shape[1] - wcfg.frame_size)
                                            // wcfg.hop_size, 1),
          f"cli.infer --arch M5 scores one value a frame ({cli_scores.shape})")
    check(cli_err <= SCORE_TOL, "the CLI's M5 scores equal the in-process ones")

    # ---- times ---------------------------------------------------------------
    log(f"[times] phase 12 on {smi}; each line's card is this one:")
    gen = torch.Generator(device=dev).manual_seed(5)
    step_ms, parts, top = {}, {}, []
    for aug in (False, True):
        st = init_state(M5(wcfg.classes_num), TRAIN_LR, dev, seed=1)
        fn_step = pipe.make_waveform_train_step(wcfg, 5.0, augment=aug)
        step_ms[aug] = time_ms(torch, lambda: fn_step(st, bufs, starts, gen))
        if not aug:
            parts, top = profile_parts(torch, lambda: fn_step(st, bufs, starts, gen),
                                       TRAIN_PROFILE_STEPS)
        log(f"[times] train step M5 augmentation {'on' if aug else 'off'}, batch {WAVE_BATCH} x "
            f"{wcfg.frame_size} samples: {step_ms[aug]:.4f} ms (CUDA-event median of {REPS}; "
            f"{WAVE_BATCH / step_ms[aug] * 1e3:.1f} im/sec; {smi})")
    if parts and top:
        part = {k.split("/")[1]: v for k, v in parts.items()}
        busy = sum(ms for _, ms in top)
        part["backward"] = busy - sum(v for k, v in part.items() if k != "backward")
        log(f"[times] M5 step by part (torch.profiler, {TRAIN_PROFILE_STEPS} steps, device ms per "
            f"step, {smi}; backward = the kernels outside the other ranges): " + ", ".join(
                f"{k} {v:.4f}" for k, v in sorted(part.items(), key=lambda r: -r[1])))
        log(f"[times] its kernels: {busy:.4f} ms a step ({busy / step_ms[False]:.1%} of the "
            f"step); the 8 largest:")
        for kname, ms in top[:8]:
            log(f"[times]   {ms:.4f} ms  {kname[:90]}")
    else:
        log("[times] M5 step by part: torch.profiler captured no device time (not measured)")
    # cuDNN picks its algorithms by heuristics (the port leaves benchmark
    # mode off); timed once with them measured at the first call instead.
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        st = init_state(M5(wcfg.classes_num), TRAIN_LR, dev, seed=1)
        fn_step = pipe.make_waveform_train_step(wcfg, 5.0, augment=False)
        bench_ms = time_ms(torch, lambda: fn_step(st, bufs, starts, gen))
    finally:
        torch.backends.cudnn.benchmark = benchmark
    log(f"[times] train step M5 augmentation off with cuDNN's benchmark mode on (a measurement "
        f"only): {bench_ms:.4f} ms (CUDA-event median of {REPS}; {smi})")
    # Both forms with STEPS_PER_CALL steps between the events, as train()
    # queues its steps without waiting for the card.
    for arch, (fresh, fn_step, b, blk) in families.items():
        st = init_state(fresh(), TRAIN_LR, dev, seed=1)
        blk_dev = torch.as_tensor(blk, device=dev)
        multi = pipe.make_multi_step(fn_step, STEPS_PER_CALL)
        one = [time_ms(torch, lambda: fn_step(st, b, blk_dev[0], gen), calls=STEPS_PER_CALL)]
        many = time_ms(torch, lambda: multi(st, b, blk_dev, gen)) / STEPS_PER_CALL
        one.append(time_ms(torch, lambda: fn_step(st, b, blk_dev[0], gen), calls=STEPS_PER_CALL))
        log(f"[times] train step {arch} (augmentation on), {STEPS_PER_CALL} steps between the "
            f"events: steps_per_call 1 {one[0]:.4f} / {one[1]:.4f} ms, steps_per_call "
            f"{STEPS_PER_CALL} {many:.4f} ms a step (CUDA-event medians of {REPS}, single steps "
            f"before and after; {smi})")
    log(f"[times] evaluate (M5, frames padded to {loop.WAVEFORM_EVAL_BUCKET}, host metrics): "
        f"{eval_ms:.2f} ms per {TRAIN_SECONDS:.0f} s validation recording; train() im/sec "
        f"{im_sec} (the reference's definition; {smi})")
    del bufs, spec_bufs, families

    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    log(f"[times] phase 12 peak device memory {peak:.1f} MiB ({smi})")
    log(f"[wavetrain] phase {time.perf_counter() - t0:.1f} s")
    return launches


def serve_phase(torch, cfg, dev, smi, tmp, mean, std):
    """Phase 13: sed_tpu's checkpoints and the live serving of MobileNetV1
    and M5 on the card (see the module docstring).  ``mean``, ``std``:
    phase 3's normalization.  Returns the launch counts of the phase's
    main-path runs, summed."""
    from scipy.io import wavfile

    from sed_tpu_torch.cli import infer
    from sed_tpu_torch.cli.serve_socket import warmup_pool
    from sed_tpu_torch.configs import WaveformConfig
    from sed_tpu_torch.inference import make_batch_predictor
    from sed_tpu_torch.models.cnn import MobileNetV1
    from sed_tpu_torch.ops import cuda_featurizer as kernels
    from sed_tpu_torch.ops.mulaw import mulaw_decode_np, mulaw_encode
    from sed_tpu_torch.serve_socket import StreamClient, StreamServer
    from sed_tpu_torch.stream_pool import StreamPool
    from sed_tpu_torch.train.checkpoint import save_checkpoint
    from sed_tpu_torch.train.state import init_state
    from sed_tpu_torch.waveform_streaming import DeviceWaveformStreamPool, WaveformStreamPool

    t0 = time.perf_counter()
    sr = chunk = cfg.working_sample_rate
    wcfg = WaveformConfig()
    served = dict.fromkeys(kernels.LAUNCHES, 0)

    def count(launches):
        for k, v in launches.items():
            served[k] += v

    # ---- the weights, their files and the audio ------------------------------
    models, pts = {}, {}
    for i, arch in enumerate(SERVE_ARCHS):
        model = infer.build_model(arch, cfg.classes_num)
        model.reset_parameters(torch.Generator().manual_seed(30 + i))
        models[arch] = seed_batch_norms(torch, model, 40 + i)
        state = init_state(copy.deepcopy(model), 1e-3, "cpu")
        state.step = SERVE_STEP
        pts[arch] = save_checkpoint(state, str(tmp / arch), SERVE_STEP)
        models[arch].to(dev)
    logits = MobileNetV1(cfg.classes_num, emit="logits")
    logits.load_state_dict(models["MobileNetV1"].state_dict())
    halo = infer.halo_floor(logits, 64)
    check(halo == 88, f"MobileNetV1's halo floor {halo}")
    with open(tmp / "mean_std.pkl", "wb") as f:
        pickle.dump({"mean": mean, "std": std}, f)
    short = str(burst_wav(tmp / "short.wav", FILE_SECONDS[1], sr, 11))
    audio = (make_signals(torch, POOL_SLOTS, sr * POOL_SECONDS, sr, dev, 13) * 32767
             ).round().to(torch.int16).cpu().numpy()
    clips = [audio[i] for i in range(POOL_SLOTS)]
    clips[EARLY_LEAVER] = clips[EARLY_LEAVER][: int(EARLY_SECONDS * sr)]
    m5_clips = list(clips)
    m5_clips[SERVE_MULAW] = mulaw_encode(clips[SERVE_MULAW])
    wavs = []
    for i, secs in enumerate(CLI_SECONDS):
        wavs.append(tmp / f"stream{i}.wav")
        wavfile.write(wavs[-1], sr, audio[i, : int(secs * sr)])

    # ---- the CLIs, in the background: converters, cli.infer, cli.stream -------
    def spec_args(arch):
        return ["--mean_std_file", tmp / "mean_std.pkl"] if arch != "M5" else []

    stream_runs = {}
    for arch, extra in SERVE_STREAM_RUNS:
        out = tmp / f"out_stream_{arch}_{'_'.join(extra)}"
        args = ["sed_tpu_torch.cli.stream", "--ckpt", pts[arch], "--arch", arch, *extra,
                *spec_args(arch), "--device", DEVICE, "--outputs_dir", out, "--slots", "2",
                "--stagger_ticks", "2", *wavs]
        stream_runs[arch, tuple(extra)] = (out, start_cli(args, out.with_suffix(".log")))
    chain = {}

    def conversions():
        """export_torch, then import_torch, then cli.infer of the imported
        file: each step the three archs side by side."""
        try:
            for step in ("export", "import", "infer"):
                procs = {}
                for arch in SERVE_ARCHS:
                    pth, run = tmp / f"{arch}.pth", tmp / f"imported_{arch}"
                    args = {
                        "export": ["sed_tpu_torch.cli.export_torch", "--ckpt", pts[arch],
                                   "--out", pth],
                        "import": ["sed_tpu_torch.cli.import_torch", "--pth", pth,
                                   "--out", run],
                        "infer": ["sed_tpu_torch.cli.infer", "--no_plot", "--ckpt",
                                  run / "checkpoints" / f"iteration_{SERVE_STEP}.pt",
                                  *spec_args(arch), "--outputs_dir", tmp / f"out_infer_{arch}",
                                  short],
                    }[step] + ["--arch", arch, "--device", DEVICE]
                    log_path = tmp / f"{step}_{arch}.log"
                    procs[arch] = (start_cli(args, log_path), log_path)
                for arch, (proc, log_path) in procs.items():
                    finish_cli(proc, log_path, f"cli.{step} --arch {arch}")
        except Exception as e:  # noqa: BLE001 - raised in the main thread
            chain["error"] = e

    chain_thread = threading.Thread(target=conversions)
    chain_thread.start()

    # ---- untimed checks beside the CLIs ---------------------------------------
    predict_mn = make_batch_predictor(models["MobileNetV1"], cfg, mean=mean, std=std,
                                      device=DEVICE)
    full = [i for i in range(POOL_SLOTS) if i != EARLY_LEAVER]
    want_mn = dict(zip(full, score_all(torch, predict_mn, [clips[i] for i in full])))
    want_mn[EARLY_LEAVER] = score_all(torch, predict_mn, [clips[EARLY_LEAVER]])[0]
    m5 = models["M5"]

    def m5_offline(y):
        f32 = mulaw_decode_np(y) if y.dtype == np.uint8 else y.astype(np.float32) / 32768.0
        frames = infer.hop_frames(torch.from_numpy(f32).to(dev)[:, None], wcfg)
        with torch.inference_mode():
            return infer.score_frames_m5(m5, frames).cpu().numpy()

    want_m5 = [m5_offline(y) for y in m5_clips]

    def max_err(got, want, what):
        err = 0.0
        for i, (g, w) in enumerate(zip(got, want)):
            check(g.shape == w.shape, f"{what} stream {i}: {g.shape} != offline {w.shape}")
            err = max(err, float(np.abs(g - w).max()))
        check(err <= SCORE_TOL, f"{what} within {SCORE_TOL} of offline scoring")
        return err

    xpool = StreamPool(copy.deepcopy(logits), cfg, slots=POOL_SLOTS, chunk_samples=chunk,
                       halo=halo, mean=mean, std=std, featurizer="xla", device=DEVICE)
    got, _, xla_launches, _, _ = drive_pool(torch, dev, xpool, clips, chunk, seed=13)
    count(xla_launches)
    xla_err = max_err(got, [want_mn[i] for i in range(POOL_SLOTS)], "MobileNetV1 pool, xla")
    check(sum(xla_launches.values()) == 0, "featurizer='xla' launches no kernel of the port")
    del xpool
    log(f"[serve] MobileNetV1 StreamPool(featurizer='xla'), {POOL_SLOTS} streams: launches "
        f"{xla_launches}; max diff vs make_batch_predictor {xla_err:.3e} (tol {SCORE_TOL})")

    server_err, server_launches = {}, dict.fromkeys(kernels.LAUNCHES, 0)
    for arch in ("MobileNetV1", "M5"):
        server_err[arch] = 0.0
        for wire, sent in (("pcm16", [audio[i, : int(s * sr)] for i, s in
                                      enumerate(SERVER_SECONDS[:2])]),
                           ("mulaw", [audio[2, : int(MULAW_SECONDS * sr)]])):
            if arch == "M5":
                spool = DeviceWaveformStreamPool(m5, wcfg, slots=len(sent), device=DEVICE)
            else:
                spool = StreamPool(copy.deepcopy(logits), cfg, slots=len(sent),
                                   chunk_samples=chunk, halo=halo, mean=mean, std=std,
                                   device=DEVICE)
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
                    check(not t.is_alive(), f"{arch} {wire} client finished")
            finally:
                server.stop()
            torch.cuda.synchronize()
            count(kernels.LAUNCHES)
            for k, n in kernels.LAUNCHES.items():
                server_launches[k] += n
            for i, y in enumerate(sent):
                if isinstance(results[i], Exception):
                    raise results[i]
                y = mulaw_encode(y) if wire == "mulaw" else y
                ref = m5_offline(y) if arch == "M5" else score_all(torch, predict_mn, [y])[0]
                server_err[arch] = max(server_err[arch], max_err([results[i]], [ref],
                                                                 f"{arch} {wire} client"))
            del spool
    log(f"[serve] StreamServer: MobileNetV1 and M5 (device pool), each with 2 pcm16 clients "
        f"and 1 mulaw client: max diff vs offline MobileNetV1 {server_err['MobileNetV1']:.3e}, "
        f"M5 {server_err['M5']:.3e} (tol {SCORE_TOL}); launches {server_launches}")
    check(server_launches["frames_stft_power"] > 0 and server_launches["mel_log"] > 0,
          "K3 and K2 ran in the MobileNetV1 server")

    # ---- the CLIs' results -------------------------------------------------------
    chain_thread.join(timeout=900)
    check(not chain_thread.is_alive(), "the converter CLIs finished")
    if "error" in chain:
        raise chain["error"]
    cpu_sd = {a: {k: v.cpu() for k, v in m.state_dict().items()} for a, m in models.items()}
    conv_err = {}
    for arch in SERVE_ARCHS:
        pth = tmp / f"{arch}.pth"
        pt = tmp / f"imported_{arch}" / "checkpoints" / f"iteration_{SERVE_STEP}.pt"
        ref = torch.load(pth, map_location="cpu", weights_only=True)
        imported = torch.load(pt, map_location="cpu", weights_only=True)
        check(ref["iterations"] == imported["step"] == SERVE_STEP, f"{arch} step carried")
        for key, value in cpu_sd[arch].items():
            if key.endswith("num_batches_tracked"):
                check(int(imported["model"][key]) == 0, f"{arch} {key} exported as 0")
            elif key.startswith("bn0."):   # MobileNetV1's dead bn0: its initial values
                fill = 1.0 if key.endswith(("weight", "running_var")) else 0.0
                check(bool((imported["model"][key] == fill).all()), f"{arch} {key}")
            else:
                check(torch.equal(ref["model"][key], value)
                      and torch.equal(imported["model"][key], value),
                      f"{arch} {key} bit-equal after export and import")
        acfg = wcfg if arch == "M5" else cfg
        if arch == "M5":
            want = infer.predict_file_m5(models[arch], short, wcfg, device=DEVICE)
        else:
            _, want = infer.predict_file(models[arch], short, cfg, mean, std, device=DEVICE)
        conv_err[arch] = 0.0
        for path in (pth, pt):
            loaded, state = infer.load_model_and_state(str(path), acfg, arch=arch,
                                                       device=DEVICE)
            check(state.step == 0 and next(loaded.parameters()).device.type == dev.type,
                  f"{arch} {path.name} loaded on the card with a fresh state")
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            if arch == "M5":
                got = infer.predict_file_m5(loaded, short, wcfg, device=DEVICE)
            else:
                _, got = infer.predict_file(loaded, short, cfg, mean, std, device=DEVICE)
            torch.cuda.synchronize()
            launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
            count(kernels.LAUNCHES)
            want_launched = {} if arch == "M5" else {"wave_stft_power": 1, "mel_log": 1}
            check(launched == want_launched, f"{arch} {path.name}: launches {launched}")
            check(got.shape == want.shape, f"{arch} {path.name} scores shape {got.shape}")
            conv_err[arch] = max(conv_err[arch], float(np.abs(got - want).max()))
        cli_got = np.load(tmp / f"out_infer_{arch}" / "short_scores.npy")
        check(cli_got.shape == want.shape, f"cli.infer --arch {arch} shape {cli_got.shape}")
        conv_err[arch] = max(conv_err[arch], float(np.abs(cli_got - want).max()))
        check(conv_err[arch] <= SCORE_TOL, f"{arch}: converted files score as the original")
    log(f"[serve] export_torch -> import_torch on the card: every weight bit-equal, step "
        f"{SERVE_STEP} carried; the .pth and the imported .pt through load_model_and_state "
        f"(one K1 + one K2 a spectrogram file) and cli.infer --no_plot on the {FILE_SECONDS[1]:.0f} "
        f"s WAV: max diff vs the original weights " + ", ".join(
            f"{a} {e:.3e}" for a, e in conv_err.items()) + f" (tol {SCORE_TOL})")
    stream_err = {}
    for (arch, extra), (out, proc) in stream_runs.items():
        finish_cli(proc, out.with_suffix(".log"), f"cli.stream --arch {arch} {extra}")
        summary = json.loads(out.with_suffix(".log").read_text().strip().splitlines()[-1])
        for path in wavs:
            got = np.load(out / f"{path.stem}_scores.npy")
            y = wavfile.read(path)[1]
            want = m5_offline(y) if arch == "M5" else score_all(torch, predict_mn, [y])[0]
            stream_err[arch, extra] = max(stream_err.get((arch, extra), 0.0),
                                          max_err([got], [want], f"cli.stream {arch} {extra}"))
        launched = summary["kernel_launches"]
        if arch == "M5":
            check(sum(launched.values()) == 0, f"cli.stream --arch M5 {extra}: no launch")
        else:
            check(launched["frames_stft_power"] > 0 and launched["mel_log"] > 0,
                  "K3 and K2 ran in cli.stream --arch MobileNetV1")
    log(f"[serve] cli.stream on {len(wavs)} WAVs (2 slots, staggered): max diff vs offline "
        + ", ".join(f"{a} {' '.join(e) or '(halo 88)'} {v:.3e}" for (a, e), v in
                    stream_err.items()) + f" (tol {SCORE_TOL}); checks "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- timed: the pools' runs, ticks and memory, nothing beside them --------
    pool = StreamPool(copy.deepcopy(logits), cfg, slots=POOL_SLOTS, chunk_samples=chunk,
                      halo=halo, mean=mean, std=std, device=DEVICE)
    got, mn_wall, mn_launches, mn_peak, ticks = drive_pool(torch, dev, pool, clips, chunk,
                                                           seed=13)
    count(mn_launches)
    mn_err = max_err(got, [want_mn[i] for i in range(POOL_SLOTS)], "MobileNetV1 pool")
    check(mn_launches["frames_stft_power"] > 0 and mn_launches["mel_log"] > 0,
          "K3 and K2 ran on MobileNetV1's streaming path")
    check(mn_launches["frames_stft_power"] == mn_launches["mel_log"]
          and sum(mn_launches.values()) == 2 * mn_launches["mel_log"],
          "MobileNetV1's pool launches K3 and K2 only, in pairs")
    del pool
    m5_runs, blocks = {}, []
    for name, make in (("device", lambda: DeviceWaveformStreamPool(m5, wcfg, slots=POOL_SLOTS,
                                                                   device=DEVICE)),
                       ("host", lambda: WaveformStreamPool(m5, wcfg, slots=POOL_SLOTS,
                                                           device=DEVICE))):
        mpool = make()
        if name == "device":
            push_rounds = mpool._push_rounds
            mpool._push_rounds = lambda rounds: (blocks.append(len(rounds)),
                                                 push_rounds(rounds))[1]
        got, wall, launches, peak, _ = drive_pool(torch, dev, mpool, m5_clips, chunk, seed=14,
                                                  backlog=SERVE_BACKLOG)
        count(launches)
        check(sum(launches.values()) == 0, f"M5 {name} pool launches no K1-K10 kernel")
        m5_runs[name] = (got, wall, peak, max_err(got, want_m5, f"M5 {name} pool"))
        if name == "device":
            check(max(blocks) == DeviceWaveformStreamPool.ROUNDS_PER_CALL,
                  f"the backlog went in blocks of {DeviceWaveformStreamPool.ROUNDS_PER_CALL} "
                  f"rounds ({max(blocks)})")
        del mpool
    pools_err = max(float(np.abs(a - b).max())
                    for a, b in zip(m5_runs["device"][0], m5_runs["host"][0]))
    check(pools_err <= SCORE_TOL, "the M5 device and host pools agree")
    log(f"[serve] MobileNetV1 StreamPool (halo {halo}), {POOL_SLOTS} streams x {POOL_SECONDS} s "
        f"int16 as phase 5, {ticks} ticks: launches {mn_launches}; max diff vs "
        f"make_batch_predictor {mn_err:.3e} (tol {SCORE_TOL})")
    log(f"[serve] M5 DeviceWaveformStreamPool and WaveformStreamPool, {POOL_SLOTS} streams "
        f"(stream {SERVE_MULAW} mulaw, stream {SERVE_BACKLOG[0]}'s first piece "
        f"{SERVE_BACKLOG[1] // sr} s: blocks of up to {max(blocks)} rounds): no launch; max "
        f"diff vs offline framing device {m5_runs['device'][3]:.3e}, host "
        f"{m5_runs['host'][3]:.3e}; device vs host {pools_err:.3e} (tol {SCORE_TOL})")

    # Ticks at 32 slots: MobileNetV1's (K3 + K2 + the model) and M5's device
    # round, one 1 s chunk a slot, by CUDA events; each pool's tick with
    # its feeds by the host clock (the host pool's work is on the host).
    tpool = StreamPool(copy.deepcopy(logits), cfg, slots=POOL_SLOTS, chunk_samples=chunk,
                       halo=halo, mean=mean, std=std, device=DEVICE)
    tslots = [tpool.join() for _ in range(POOL_SLOTS)]
    for k in range(2):
        tpool.push({s: audio[s, k * chunk: (k + 1) * chunk] for s in tslots})
    check(len(tpool._admitted) == POOL_SLOTS, "every timing slot admitted")
    one = {s: audio[s, 2 * chunk: 3 * chunk] for s in tslots}
    mn_tick_ms = time_ms(torch, lambda: tpool._push_rounds([one]))
    mn_kernels = profile_ticks(torch, lambda: tpool._push_rounds([one]), n=5)
    dpool = DeviceWaveformStreamPool(m5, wcfg, slots=POOL_SLOTS, device=DEVICE)
    dslots = [dpool.join() for _ in range(POOL_SLOTS)]
    for k in range(2):
        dpool.push({s: audio[s, k * chunk: (k + 1) * chunk] for s in dslots})
    m5_tick_ms = time_ms(torch, lambda: dpool._push_rounds([one]))
    m5_kernels = profile_ticks(torch, lambda: dpool._push_rounds([one]), n=5)
    hpool = WaveformStreamPool(m5, wcfg, slots=POOL_SLOTS, device=DEVICE)
    hslots = [hpool.join() for _ in range(POOL_SLOTS)]

    def host_tick_ms(p, slots):
        times = []
        for rep in range(REPS + 3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for s in slots:
                p.feed(s, one[s])
            p.tick()
            torch.cuda.synchronize()
            if rep >= 3:
                times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    dev_tick_host_ms = host_tick_ms(dpool, dslots)
    host_tick_host_ms = host_tick_ms(hpool, hslots)
    del tpool, dpool, hpool

    audio_s = sum(len(c) for c in clips) / sr
    log(f"[times] phase 13 on {smi}; each line's card is this one:")
    log(f"[times] MobileNetV1 pool tick, one round of {POOL_SLOTS} slots (K3 + K2 + "
        f"MobileNetV1): {mn_tick_ms:.4f} ms (CUDA-event median of {REPS})")
    log(f"[times] M5 device pool round, {POOL_SLOTS} slots x 1 s ({POOL_SLOTS} x "
        f"{(chunk - 1) // wcfg.hop_size + 1} frames scored): {m5_tick_ms:.4f} ms (CUDA-event "
        f"median of {REPS})")
    log(f"[times] feed {POOL_SLOTS} x 1 s + tick(), host clock, median of {REPS}: M5 device "
        f"pool {dev_tick_host_ms:.4f} ms | M5 host pool {host_tick_host_ms:.4f} ms (host / "
        f"device {host_tick_host_ms / dev_tick_host_ms:.3f})")
    for what, rows, tick_ms in (("MobileNetV1 pool tick", mn_kernels, mn_tick_ms),
                                ("M5 device pool round", m5_kernels, m5_tick_ms)):
        if rows:
            busy = sum(ms for _, ms in rows)
            log(f"[times] {what} on the device (torch.profiler, 5 ticks): {busy:.4f} ms of "
                f"kernels a tick, {busy / tick_ms:.1%} of the {tick_ms:.4f} ms tick; the 8 "
                f"largest and the port's own:")
            for i, (kname, ms) in enumerate(rows):
                if i < 8 or any(k in kname for k in kernels.LAUNCHES):
                    log(f"[times]   {ms:.4f} ms  {kname[:90]}")
        else:
            log(f"[times] {what} on the device: torch.profiler captured no device time "
                f"(not measured)")
    for what, wall, peak in (("MobileNetV1 pool", mn_wall, mn_peak),
                             ("M5 device pool", m5_runs["device"][1], m5_runs["device"][2]),
                             ("M5 host pool", m5_runs["host"][1], m5_runs["host"][2])):
        log(f"[times] {what} run: {audio_s:.1f} audio-s in {wall:.3f} wall-s = "
            f"{audio_s / wall:.1f} audio-s per wall-s; peak device memory {peak:.1f} MiB")
    log(f"[serve] launches on phase 13's main path: {served}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    return served


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

    # The script's own reference forwards and timings run in full float32,
    # as each entry point of the port does for its own call.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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
    got_pool, pool_wall, pool_launches, pool_peak_mib, tick = drive_pool(
        torch, dev, pool, clips, chunk, seed=2)
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
    for i, got in enumerate(got_pool):
        check(got.shape == want[i].shape,
              f"stream {i}: {got.shape[0]} frames, offline {want[i].shape[0]}")
        pool_err = max(pool_err, float(np.abs(got - want[i]).max()))
    log(f"[pool] every stream's frame count equals offline; max diff vs "
        f"make_batch_predictor {pool_err:.3e} (tol {SCORE_TOL}); "
        f"{time.perf_counter() - t0:.1f} s")
    check(pool_err <= SCORE_TOL, "pool scores match make_batch_predictor")
    profile = pool.profile
    del pool, got_pool

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

    # ---- 11. training; 12. M5 training on the same corpus -------------------
    with tempfile.TemporaryDirectory() as train_tmp:
        train_launches, corpus = train_phase(torch, cfg, dev, smi, Path(train_tmp))
        log(f"[train] total {time.perf_counter() - phase_t0:.1f} s")
        wave_launches = wavetrain_phase(torch, cfg, dev, smi, Path(train_tmp), corpus)
        del corpus
    log(f"[wavetrain] total {time.perf_counter() - phase_t0:.1f} s")

    # ---- 13. checkpoints and the live serving of MobileNetV1 and M5 ----------
    with tempfile.TemporaryDirectory() as serve_tmp:
        serve_launches = serve_phase(torch, cfg, dev, smi, Path(serve_tmp), mean, std)
    log(f"[serve] total {time.perf_counter() - phase_t0:.1f} s")

    source = "sed_tpu_torch/ops/csrc/featurizer.cu"
    entries = [
        {"name": "wave_stft_power",
         "kernel": "wave_stft_power_kernel<LOG2_M> (stockham_fft, PackedWaveLoad, PowerStore)",
         "route": "cuda", "source": source,
         "replaces": "sed_tpu/ops/pallas_featurizer.py:412",
         "launches": launches["wave_stft_power"],
         "file_launches": file_launches["wave_stft_power"],
         "train_launches": train_launches["wave_stft_power"], "max_abs_err": k1_abs,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": k1_lib_ms},
        {"name": "mel_log",
         "kernel": "mel_log_kernel<R> (bulk copies into a ring, segment_sums)",
         "route": "cuda", "source": source,
         "replaces": "sed_tpu/ops/pallas_featurizer.py:72",
         "launches": launches["mel_log"], "file_launches": file_launches["mel_log"],
         "train_launches": train_launches["mel_log"],
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
    ]
    for e in entries:   # phase 12's path, M5 training: every count is 0
        e["wavetrain_launches"] = sum(wave_launches[k] for k in ENTRY_COUNTERS[e["name"]])
        e["serve_launches"] = sum(serve_launches[k] for k in ENTRY_COUNTERS[e["name"]])
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        stop_background()
