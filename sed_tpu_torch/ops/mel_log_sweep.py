"""Time variants of K2's geometry on a CUDA card.

Each variant is ``csrc/featurizer.cu`` with a few constants edited (the
chunk size, the ring's slots, the summing warps, the rows summed at once),
built by nvcc beside the real library, and
also rebuilt without its copies and without its sums (wrong results, timing
only), so that K2's time splits into copies and sums.  Each is timed through
the same C call as K2 on the production filterbank at 2912 rows (the
scoring batch) and 160 rows (the 32-slot tick), one call and 20 queued
between two CUDA events (median of 20), beside its error against float64.

    python -m sed_tpu_torch.ops.mel_log_sweep [variant ...]

Run it on the card (the builds take ~2 minutes on 8 cores); it prints one
line per build.  A variant whose edit no longer matches the source fails
before anything is built.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from sed_tpu_torch.configs import SpectrogramConfig
from sed_tpu_torch.ops import cuda_featurizer as kernels
from sed_tpu_torch.ops.mel import mel_filterbank

CHUNK = "constexpr int kMelChunk = R == 1 ? 1024 : 2048;"
SLOTS = "constexpr int kMelSlots = R == 1 ? 16 : 4;"
WARPS = "constexpr int kMelConsumerWarps = 16;"
ROWS = "constexpr int kMelRows = 4;"
BLOCKS = "constexpr int kMelMinBlocks = R == 1 ? 2 : 1;"
# name -> [(text in featurizer.cu, replacement), ...]
VARIANTS = {
    "base": [],
    "chunk1024": [(CHUNK, "constexpr int kMelChunk = 1024;"),
                  (SLOTS, "constexpr int kMelSlots = R == 1 ? 16 : 8;")],
    "chunk512": [(CHUNK, "constexpr int kMelChunk = 512;"),
                 (SLOTS, "constexpr int kMelSlots = R == 1 ? 32 : 16;")],
    "warps8": [(WARPS, "constexpr int kMelConsumerWarps = 8;")],
    "warps24": [(WARPS, "constexpr int kMelConsumerWarps = 24;")],
    "rows2": [(ROWS, "constexpr int kMelRows = 2;"),
              (BLOCKS, "constexpr int kMelMinBlocks = R <= 2 ? 2 : 1;"),
              (SLOTS, "constexpr int kMelSlots = R == 1 ? 16 : (R == 2 ? 8 : 4);")],
}
# The two lesions of every variant: its copies, its sums.
LESIONS = {
    "nocopies": ("        stage_chunk<R>(a, ring, full, g, k, seq, lane);",
                 "        mbar_arrive(full + seq % D); if (lane == 0) mbar_arrive(full + seq % D);"),
    "nosums": ("        segment_sums<R, kPasses>(x, w, s.y, lane, sum);",
               "        for (int r = 0; r < R; ++r) sum[r] = 0.f;"),
}


def edited(source: str, edits) -> str:
    for old, new in edits:
        if source.count(old) != 1:
            raise ValueError(f"edit does not match featurizer.cu once: {old!r}")
        source = source.replace(old, new)
    return source


def build(tag: str, source: str):
    out = kernels.BUILD_DIR / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{tag}.cu", out / f"lib{tag}.so"
    cu.write_text(source)
    # K2 alone is timed: the tier kernel's instances are left out.
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-DSED_FEATURIZER_NO_TIERS",
                           "-o", str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{tag}: nvcc failed\n{proc.stderr[-3000:]}")
    return so


def median_ms(fn, calls: int, reps: int = 20) -> float:
    for _ in range(3):
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


def main(names) -> int:
    if not torch.cuda.is_available():
        print("mel_log_sweep needs a CUDA card", file=sys.stderr)
        return 1
    source = kernels.SOURCE.read_text()
    jobs = {}
    for name in names:
        jobs[name] = edited(source, VARIANTS[name])
        for lesion, edit in LESIONS.items():
            jobs[f"{name}_{lesion}"] = edited(source, VARIANTS[name] + [edit])
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        libs = dict(zip(jobs, pool.map(lambda item: build(*item), jobs.items())))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{smi}; {len(libs)} builds in {time.perf_counter() - t0:.1f} s", flush=True)

    dev = torch.device("cuda", 0)
    cfg = SpectrogramConfig()
    bands = kernels.mel_bands(cfg, dev)
    fb64 = torch.from_numpy(mel_filterbank(cfg, np.float64)).to(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    batch = torch.rand(2912, cfg.freq_bins, generator=g, device=dev) ** 4 * 1e3
    inputs = {rows: (batch[:rows].contiguous(), kernels.mel_log_plain(batch[:rows].double(), fb64))
              for rows in (2912, 160)}
    stream = torch.cuda.current_stream(dev).cuda_stream
    typed = kernels._library().sed_mel_log
    for tag, so in libs.items():
        fn = getattr(ctypes.CDLL(str(so)), "sed_mel_log")
        fn.argtypes, fn.restype = typed.argtypes, typed.restype
        line = [f"{tag:22s}"]
        for rows, (power, want) in inputs.items():
            out = torch.empty(rows, bands.n_mels, device=dev)

            def call(power=power, out=out):
                err = fn(power.data_ptr(), bands.segments.data_ptr(),
                         bands.band_first.data_ptr(), bands.work.data_ptr(),
                         bands.weights.data_ptr(), out.data_ptr(), rows, bands.n_bins,
                         bands.n_mels, bands.n_segments, *bands.span, 0, dev.index,
                         stream)
                if err:
                    raise RuntimeError(f"{tag}: launch failed ({err})")

            call()
            torch.cuda.synchronize()
            err = float((out.double() - want).abs().max())
            line.append(f"{rows} rows: {median_ms(call, 1):.4f} ms one, "
                        f"{median_ms(call, 20):.4f} queued, err {err:.2e} dB")
        print(" | ".join(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or list(VARIANTS)))
