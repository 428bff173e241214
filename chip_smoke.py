#!/usr/bin/env python3
"""On-card smoke test and first measurements of sed_tpu_torch.

Run from the repository root on a machine with one CUDA card (an H100):

    python3 chip_smoke.py

It drives the PyTorch + CUDA port only (nothing of JAX or sed_tpu) and exits
non-zero on the first failure.  Phases:

  1. card     device name, ``nvidia-smi`` name and power limit; builds the
              kernels from ``sed_tpu_torch/ops/csrc`` with nvcc and prints
              the build time and ptxas' registers, shared memory and spills;
  2. kernels  K1 and K2 against their plain versions computed in float64 on
              the card, at the main path's shapes (16 x 60 s);
  3. slice    ``make_batch_predictor(device="cuda")`` with
              CnnAvgPooling(TRAIN_CHANNEL_AND_POOL) on 16 x 60 s int16 clips,
              then one uint8 µ-law batch; launch counts reset just before and
              read just after; clip 0 against ``device="cpu"``;
  4. CLI      ``python -m sed_tpu_torch.cli.infer --batch`` on two WAV files;
  5. times    CUDA-event medians of K1, K2, their plain versions, a PyTorch
              yardstick for each, the featurizer, the model and the whole
              16 x 60 s batch; audio-s/s; peak device memory.

Then one ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import pickle
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
BATCH = 16          # clips in the scored batch (bench.py's production batch)
SECONDS = 60
K1_REL_TOL = 1e-5   # K1: abs error / frame peak power, against float64
DB_TOL = 1e-4       # K2 and K1+K2: dB, against float64
SCORE_TOL = 1e-4    # scores, card against CPU: another summation order
REPS = 20

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


def time_ms(torch, fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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
    from sed_tpu_torch.ops.featurizer import logmel_features_batch
    from sed_tpu_torch.ops.mel import mel_filterbank
    from sed_tpu_torch.ops.mulaw import mulaw_encode

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device 0: {name}, device count {count}")
    log(f"[card] nvidia-smi: {smi}")
    info = kernels.build(force=True)
    log(f"[card] nvcc build: {info.seconds:.2f} s -> {info.path.relative_to(REPO)}")
    for line in info.log.splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill")):
            log(f"[card] ptxas: {line.strip()}")
    bw, flops_peak = card_peaks(name)

    hop, n_fft, n_bins = cfg.hop_size, cfg.nfft, cfg.freq_bins
    samples = cfg.working_sample_rate * SECONDS
    window = kernels.stft_window(cfg, dev)
    bands = kernels.mel_bands(cfg, dev)
    fb64 = torch.from_numpy(mel_filterbank(cfg, np.float64)).to(dev)

    # ---- 2. kernels vs their plain versions (float64) ---------------------
    t0 = time.perf_counter()
    waves = make_signals(torch, BATCH, samples, cfg.working_sample_rate, dev, 0)
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
    log(f"[kernels] launches so far {kernels.LAUNCHES}; "
        f"{time.perf_counter() - t0:.1f} s")
    del waves, power, ref, k1_err, rows, mel

    # ---- 3. the slice through make_batch_predictor ------------------------
    t0 = time.perf_counter()
    model = CnnAvgPooling(cfg.classes_num, TRAIN_CHANNEL_AND_POOL,
                          generator=torch.Generator().manual_seed(0))
    cpu_model = copy.deepcopy(model)
    pcm = (make_signals(torch, BATCH, samples, cfg.working_sample_rate, dev, 1)
           * 32767).round().to(torch.int16)[..., None]
    mu = torch.from_numpy(mulaw_encode(pcm.cpu().numpy())).to(dev)
    # Per-mel-bin normalization statistics, as preprocessing computes them
    # from training features; they keep the random model out of saturation.
    with torch.inference_mode():
        feats = logmel_features_batch(pcm[:4], cfg)
    mean = feats.mean(dim=(0, 1, 2)).cpu().numpy()
    std = feats.std(dim=(0, 1, 2)).cpu().numpy()
    predict = make_batch_predictor(model, cfg, mean=mean, std=std, device="cuda")
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    scores = predict(pcm)
    scores_mu = predict(mu)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(f"[slice] launches on the main path: {launches}")
    check(all(n > 0 for n in launches.values()), "every kernel ran on the main path")
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

    # ---- 4. the CLI entry point --------------------------------------------
    t0 = time.perf_counter()
    from scipy.io import wavfile

    from sed_tpu_torch.io.audio import read_multichannel_audio

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        sr = cfg.working_sample_rate
        wavs = []
        for i, secs in enumerate((20, 30)):
            path = tmp / f"clip{i}.wav"
            wavfile.write(path, sr, pcm[i, : secs * sr, 0].cpu().numpy())
            wavs.append(path)
        torch.save({"iterations": 0, "model": model.state_dict(), "optimizer": {}},
                   tmp / "model.pth")
        with open(tmp / "mean_std.pkl", "wb") as f:
            pickle.dump({"mean": mean, "std": std}, f)
        out = tmp / "out"
        cmd = [sys.executable, "-m", "sed_tpu_torch.cli.infer", "--batch",
               "--ckpt", str(tmp / "model.pth"), "--outputs_dir", str(out),
               "--mean_std_file", str(tmp / "mean_std.pkl"),
               "--event_threshold", "0.5", *map(str, wavs)]
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
        check(proc.returncode == 0, f"CLI exit code {proc.returncode}")
        cli_err = 0.0
        for path in wavs:
            got = np.load(out / f"{path.stem}_scores.npy")
            wav = read_multichannel_audio(str(path), target_fs=sr, cfg=cfg)
            want = predict(wav[None].astype(np.float32))[0].cpu().numpy()
            check(got.shape == want.shape, f"CLI scores shape {got.shape}")
            cli_err = max(cli_err, float(np.abs(got - want).max()))
            for suffix in ("_scores.csv", "_events.csv"):
                check((out / f"{path.stem}{suffix}").is_file(), f"CLI wrote {suffix}")
        log(f"[cli] {len(wavs)} files scored by sed_tpu_torch.cli.infer --batch; "
            f"max diff vs make_batch_predictor {cli_err:.3e} (tol {SCORE_TOL}); "
            f"{time.perf_counter() - t0:.1f} s")
        check(cli_err <= SCORE_TOL, "CLI scores match make_batch_predictor")

    # ---- 5. times at the main path's shapes (16 x 60 s) --------------------
    t0 = time.perf_counter()
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

    m = n_fft // 2
    win_nnz = int(torch.count_nonzero(window))
    k1_bytes = 4 * (signals.numel() + n_fft + 2 * m + rows.numel())
    k1_ops = frames * (5 * m * (m.bit_length() - 1) + 19 * m + win_nnz)
    nnz = bands.weights.numel()
    k2_bytes = 4 * (rows.numel() + frames * bands.n_mels + nnz + 3 * bands.n_mels)
    k2_ops = frames * 2 * nnz

    def bound(n_bytes, n_ops):
        t_bytes, t_ops = n_bytes / bw * 1e3, n_ops / flops_peak * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    k1_bound, k1_by = bound(k1_bytes, k1_ops)
    k2_bound, k2_by = bound(k2_bytes, k2_ops)
    log(f"[times] {smi}; {BATCH} x {SECONDS} s, {frames} frames; CUDA-event median of {REPS}")
    log(f"[times] K1 wave_stft_power {k1_ms:.4f} ms | plain {k1_plain_ms:.4f} ms | "
        f"torch.stft+abs^2 {k1_lib_ms:.4f} ms | bound {k1_bound:.4f} ms ({k1_by}: "
        f"{k1_bytes / 1e6:.1f} MB, {k1_ops / 1e9:.2f} GFLOP)")
    log(f"[times] K2 mel_log {k2_ms:.4f} ms | plain {k2_plain_ms:.4f} ms | "
        f"matmul+log10 {k2_lib_ms:.4f} ms | bound {k2_bound:.4f} ms ({k2_by}: "
        f"{k2_bytes / 1e6:.1f} MB, {k2_ops / 1e9:.3f} GFLOP)")
    log(f"[times] featurizer (int16 ingest + K1 + K2) {feat_ms:.4f} ms | "
        f"CnnAvgPooling {model_ms:.4f} ms | whole batch {batch_ms:.4f} ms")
    log(f"[times] {audio_s_per_s:.1f} audio-s/s; peak device memory {peak_mib:.1f} MiB; "
        f"{time.perf_counter() - t0:.1f} s; total {time.perf_counter() - phase_t0:.1f} s")

    source = "sed_tpu_torch/ops/csrc/featurizer.cu"
    print(json.dumps({"kernels": [
        {"name": "wave_stft_power", "route": "cuda", "source": source,
         "replaces": "sed_tpu/ops/pallas_featurizer.py:412",
         "launches": launches["wave_stft_power"], "max_abs_err": k1_abs,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": k1_lib_ms},
        {"name": "mel_log", "route": "cuda", "source": source,
         "replaces": "sed_tpu/ops/pallas_featurizer.py:72",
         "launches": launches["mel_log"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": k2_lib_ms},
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
