"""Time the tier routes (the split pass, the fused kernel, the GEMMs) on a
CUDA card.

Three commands, each printing one JSON line per measurement:

    python -m sed_tpu_torch.ops.tier_gemm_sweep turns PARENT_DIR
    python -m sed_tpu_torch.ops.tier_gemm_sweep routes
    python -m sed_tpu_torch.ops.tier_gemm_sweep variants [variant ...]

``turns`` times this tree's and another checkout's (``PARENT_DIR``, e.g. a
``git archive`` of the parent commit) tier routes on 16 x 60 s of noise, in
four turns (parent, this, this, parent), each tree in a process of its own
after both libraries were built side by side: K1t, K3t (2912 float32 rows
and a 32-slot tick's 160, queued), K5t and K6t at 48 and 96 kHz at fast and
turbo, with K1 and K2 beside them; in a tree with the fused route, its
split pass and fused kernel on their own through the C calls, and the
tier GEMMs' route at n_fft 32768 as a yardstick; the batch (16 x 60 s
int16 through ``make_batch_predictor`` with a seeded CnnAvgPooling) at
parity, fast and turbo; at fast, K1t, K3t, K5t and K6t at 384 kHz and
1.536 MHz, K1t and K6t at 1 kHz (with a call's host time, nothing
synchronised, since the small end is bound by the host), K6t at 2 kHz,
and the peak device memory of the 2^20 K1t call.

``routes`` times, at each n_fft the fused kernel takes (2048..32768) and
each (inner, outer) pass count whose shape fits, both of K1t's routes over
the same 2912 frames of noise through the C calls, in turns (fused, GEMMs,
GEMMs, fused): the split pass then ``sed_tier_dft_power``, and the split
pass then the two GEMM stages; with the route the library's plan takes
there (``sed_tier_fused_plan``), so that the plan's crossover can be read
against the times.

``variants`` builds, from ``csrc/featurizer.cu`` and from each named
variant of it (a few edits of its text: lesions that skip a part of a
kernel, giving wrong results, to split a kernel's time), the objects the
variant's kernel needs, side by side, then times them through the C calls
in turns with the unedited build first and last: each launch of K1t's GEMM
route at fast over every frame group at 384 kHz and 1.536 MHz.  A variant
whose edit no longer matches the source fails before anything is built.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

# name -> [(text in featurizer.cu, replacement), ...]
_T_STORES = ("            *reinterpret_cast<uint4*>(t_row + (static_cast<long long>(c) * kt2 + "
             "(k >> 6)) *")
VARIANTS = {
    # stage 1 without its T stores (the twiddle and the split kept)
    "no_t_store": [(_T_STORES, "            if (w[part][c][0] == 0x7fc01234u) *reinterpret_cast<"
                               "uint4*>(t_row + (static_cast<long long>(c) * kt2 + (k >> 6)) *")],
    # stage 1 without its epilogue: the products alone
    "no_epilogue": [("    const int k2 = static_cast<int>((row >> 4) * 8 + (row & 7));\n"
                     "    if (k2 >= n2) return;",
                     "    const int k2 = static_cast<int>((row >> 4) * 8 + (row & 7));\n"
                     "    if (k2 >= n2 || acc[0] != 1.2345678e30f) return;")],
}
RATES = (384000, 1536000)
MAIN_RATES = (48000, 96000)


def _median_ms(torch, fn, reps: int, warmup: int) -> float:
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


def _noise(torch, sr: int, dev):
    g = torch.Generator(device=dev).manual_seed(1)
    return (0.3 * torch.randn(16, 60 * sr, generator=g, device=dev)).contiguous()


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def times(tree: str) -> dict:
    """The routes of the checkout at ``tree`` (its package imported from
    there: this file run by its path), as ``turns`` describes them."""
    sys.path.insert(0, tree)
    import torch

    from sed_tpu_torch.configs import SpectrogramConfig
    from sed_tpu_torch.ops import cuda_featurizer as kernels
    from sed_tpu_torch.ops import stft as stft_ops

    kernels.build()
    dev = torch.device("cuda", 0)
    fast = "bf16x3"
    out = {"tree": tree, "smi": _smi()}
    out.update(_batch_times(torch, dev))
    for sr in MAIN_RATES:
        out.update(_main_times(torch, kernels, stft_ops, SpectrogramConfig(working_sample_rate=sr),
                               dev))
    for sr in (1000, 2000) + RATES:
        cfg = SpectrogramConfig(working_sample_rate=sr)
        hop, n_fft = cfg.hop_size, cfg.nfft
        waves = _noise(torch, sr, dev)
        window, bands = kernels.stft_window(cfg, dev), kernels.mel_bands(cfg, dev)
        big = sr in RATES
        reps = dict(reps=3, warmup=1) if big else dict(reps=20, warmup=3)
        calls = {"k6t": lambda: kernels.wave_packed_fft_bf16(waves, window, hop, n_fft, fast)}
        if sr != 2000:
            calls["k1t"] = lambda: kernels.wave_dft_power_bf16(waves, window, hop, n_fft, fast)
        if big:
            calls["k5t"] = lambda: kernels.wave_stft_mel_log_bf16(waves, window, hop, n_fft,
                                                                  bands, fast)
        for name, fn in calls.items():
            out[f"{name}_{sr}"] = _median_ms(torch, fn, **reps)
            if not big:   # a call's host time, nothing synchronised
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(50):
                    fn()
                out[f"{name}_{sr}_host_ms"] = (time.perf_counter() - t0) / 50 * 1e3
                torch.cuda.synchronize()
        if big:
            rows = stft_ops.frame_signal(waves, n_fft, hop).reshape(-1, n_fft).contiguous()
            out[f"k3t_{sr}"] = _median_ms(torch, lambda: kernels.frames_dft_power_bf16(
                rows, window, n_fft, fast), **reps)
            del rows
        if sr == RATES[-1]:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            out["base_gb"] = torch.cuda.memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
            power = kernels.wave_dft_power_bf16(waves, window, hop, n_fft, fast)
            torch.cuda.synchronize()
            out[f"k1t_{sr}_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            del power
        del waves
        torch.cuda.empty_cache()
    return out


def _batch_times(torch, dev) -> dict:
    """``turns``' batch: 16 x 60 s of int16 noise at 48 kHz through
    ``make_batch_predictor`` with a seeded CnnAvgPooling, at parity, fast
    and turbo."""
    import numpy as np

    from sed_tpu_torch.configs import DEFAULT_SPECTROGRAM as cfg
    from sed_tpu_torch.inference import make_batch_predictor
    from sed_tpu_torch.models.cnn import TRAIN_CHANNEL_AND_POOL, CnnAvgPooling

    model = CnnAvgPooling(cfg.classes_num, TRAIN_CHANNEL_AND_POOL,
                          generator=torch.Generator().manual_seed(10)).to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(2)
    pcm = (0.3 * 32767 * torch.randn(16, 60 * cfg.working_sample_rate, 1, generator=g,
                                     device=dev)).clamp(-32768, 32767).to(torch.int16)
    mean, std = np.zeros(cfg.mel_bins, np.float32), np.ones(cfg.mel_bins, np.float32)
    out = {}
    for tier in ("parity", "fast", "turbo"):
        predict = make_batch_predictor(model, cfg, mean=mean, std=std,
                                       featurizer_precision=tier)
        out[f"batch_{tier}"] = _median_ms(torch, lambda: predict(pcm), reps=20, warmup=3)
    del pcm, model
    torch.cuda.empty_cache()
    return out


def _main_times(torch, kernels, stft_ops, cfg, dev) -> dict:
    """``turns``' times at a main rate (48 or 96 kHz): K1t, K3t, K5t and K6t
    at fast and turbo, K1 and K2, the fused route's parts and the GEMMs'
    route at n_fft 32768."""
    sr, hop, n_fft = cfg.working_sample_rate, cfg.hop_size, cfg.nfft
    waves = _noise(torch, sr, dev)
    window, bands = kernels.stft_window(cfg, dev), kernels.mel_bands(cfg, dev)
    rows = stft_ops.frame_signal(waves, n_fft, hop).reshape(-1, n_fft).contiguous()
    tick = rows[:160].contiguous()
    reps = dict(reps=20, warmup=3)
    out = {f"k1_{sr}": _median_ms(torch, lambda: kernels.wave_stft_power(waves, window, hop,
                                                                         n_fft), **reps)}
    power = kernels.wave_stft_power(waves, window, hop, n_fft).reshape(-1, n_fft // 2 + 1)
    out[f"k2_{sr}"] = _median_ms(torch, lambda: kernels.mel_log(power, bands), **reps)
    del power
    for tier in ("bf16x3", "bf16x1"):
        calls = {
            "k1t": lambda: kernels.wave_dft_power_bf16(waves, window, hop, n_fft, tier),
            "k5t": lambda: kernels.wave_stft_mel_log_bf16(waves, window, hop, n_fft, bands, tier),
            "k3t": lambda: kernels.frames_dft_power_bf16(rows, window, n_fft, tier),
            "k6t": lambda: kernels.wave_packed_fft_bf16(waves, window, hop, n_fft, tier)}
        for name, fn in calls.items():
            out[f"{name}_{sr}_{tier}"] = _median_ms(torch, fn, **reps)

        def queued():   # a tick's 160 rows, 20 calls in a row
            for _ in range(20):
                kernels.frames_dft_power_bf16(tick, window, n_fft, tier)
        out[f"k3t_{sr}_{tier}_160_queued"] = _median_ms(torch, queued, reps=5, warmup=1) / 20
        if hasattr(kernels, "fused_plan"):
            out.update(_fused_parts(torch, kernels, waves, window, cfg, tier, dev))
    del rows, tick, waves
    torch.cuda.empty_cache()
    return out


def _fused_parts(torch, kernels, waves, window, cfg, tier, dev) -> dict:
    """K1t's split pass and fused kernel on their own through the C calls,
    wherever the kernel's shape fits (the plan's route or not); at n_fft
    32768 also the tier GEMMs' route over the same frames (split, stage 1,
    stage 2), their C entries taking that size as they are."""
    sr, hop, n_fft = cfg.working_sample_rate, cfg.hop_size, cfg.nfft
    passes = kernels.tier_passes(tier)
    inner, outer = passes
    lib, stream = kernels._library(), torch.cuda.current_stream(dev).cuda_stream
    n_frames = 1 + waves.shape[1] // hop
    frames = waves.shape[0] * n_frames
    shape = (*kernels._gemm_dims(n_fft), 0, inner, outer)
    power = torch.empty((frames, n_fft // 2 + 1), device=dev)
    out = {}
    plan = kernels.fused_plan(n_fft, passes, frames, dev)
    if plan["np"] and plan["group_frames"] == frames:   # the kernel fits, the plan's route or not
        tab1, tab2, tw = kernels._gemm_images(n_fft, False, kernels._tier_chunks(inner),
                                              kernels._tier_chunks(outer), plan["tab1_rows"],
                                              plan["tab2_rows"], dev)
        x = torch.empty(plan["x_bytes"], dtype=torch.uint8, device=dev)
        split = lambda: lib.sed_tier_split(waves.data_ptr(), 0, window.data_ptr(), x.data_ptr(),
                                           0, frames, waves.shape[1], n_frames, hop, *shape, 0,
                                           stream)
        fused = lambda: lib.sed_tier_dft_power(x.data_ptr(), tab1.data_ptr(), tab2.data_ptr(),
                                               tw.data_ptr(), power.data_ptr(), frames,
                                               n_fft.bit_length() - 1, inner, outer, 0, stream)
        if split() or fused():
            raise RuntimeError("the fused route's C calls failed")
        out[f"split_{sr}_{tier}"] = _median_ms(torch, split, reps=20, warmup=3)
        out[f"fused_{sr}_{tier}"] = _median_ms(torch, fused, reps=20, warmup=3)
        del x
    if n_fft == 32768:
        gp = kernels.gemm_plan(n_fft, False, passes, frames)
        tab1, tab2, tw = kernels._gemm_images(n_fft, False, kernels._tier_chunks(inner),
                                              kernels._tier_chunks(outer), gp["tab1_rows"],
                                              gp["tab2_rows"], dev)
        scratch = torch.empty(gp["scratch_bytes"], dtype=torch.uint8, device=dev)
        x, t = scratch.data_ptr(), scratch.data_ptr() + gp["x_bytes"]
        groups = kernels.frame_groups(frames, gp["group_frames"])

        def gemms():
            for r0, g in groups:
                err = (lib.sed_tier_split(waves.data_ptr(), 0, window.data_ptr(), x, r0, g,
                                          waves.shape[1], n_frames, hop, *shape, 0, stream)
                       or lib.sed_tier_inner(x, tab1.data_ptr(), tw.data_ptr(), t, g, *shape, 0,
                                             stream)
                       or lib.sed_tier_outer(t, tab2.data_ptr(),
                                             power[r0:].data_ptr(), None, g, *shape, 0, stream))
                if err:
                    raise RuntimeError("the tier GEMMs' C calls failed")
        out[f"gemm_route_{sr}_{tier}"] = _median_ms(torch, gemms, reps=10, warmup=2)
        del scratch
    return out


def turns(parent: str) -> None:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parent = os.path.abspath(parent)
    # This file run by its path: each process imports the package of its tree.
    me = [sys.executable, os.path.abspath(__file__)]

    def run(tree, build=False):
        cmd = me + (["build", tree] if build else ["times", tree])
        done = subprocess.run(cmd, capture_output=True, text=True, cwd=tree)
        if done.returncode:
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{done.stdout}\n{done.stderr}")
        return done.stdout.strip().splitlines()[-1]

    with ThreadPoolExecutor(2) as pool:   # both libraries, side by side
        for line in pool.map(lambda t: run(t, build=True), (parent, here)):
            print(line, flush=True)
    for tree in (parent, here, here, parent):
        print(run(tree), flush=True)


def routes(frames: int = 2912) -> None:
    """``routes`` (see the module docstring): one JSON line a size and pass
    count."""
    import torch

    from sed_tpu_torch.ops import cuda_featurizer as kernels

    kernels.build()
    dev = torch.device("cuda", 0)
    lib, stream = kernels._library(), torch.cuda.current_stream(dev).cuda_stream
    print(json.dumps({"smi": _smi(), "frames": frames}), flush=True)
    for log2_n in range(11, 16):
        n_fft = 1 << log2_n
        g = torch.Generator(device=dev).manual_seed(3)
        rows = 0.3 * torch.randn(frames, n_fft, generator=g, device=dev)
        window = torch.hann_window(n_fft, device=dev)
        fused_out = torch.empty((frames, n_fft // 2 + 1), device=dev)
        gemm_out = torch.empty_like(fused_out)
        for passes in kernels._EVERY_PASSES:
            inner, outer = passes
            shape = (*kernels._gemm_dims(n_fft), 0, inner, outer)
            fp = kernels.fused_plan(n_fft, passes, frames, dev)
            line = {"n_fft": n_fft, "inner": inner, "outer": outer,
                    "plan_route": "fused" if fp["fused"] else "gemm", "np": fp["np"],
                    "slots": fp["slots"]}
            if not fp["np"]:   # no shape fits: the GEMMs alone
                print(json.dumps(line), flush=True)
                continue
            gp = kernels.gemm_plan(n_fft, False, passes, frames)
            chunks = (kernels._tier_chunks(inner), kernels._tier_chunks(outer))
            tab1, tab2, tw = kernels._gemm_images(n_fft, False, *chunks, gp["tab1_rows"],
                                                  gp["tab2_rows"], dev)
            scratch = torch.empty(max(fp["x_bytes"], gp["scratch_bytes"]), dtype=torch.uint8,
                                  device=dev)
            x, t = scratch.data_ptr(), scratch.data_ptr() + gp["x_bytes"]

            def split(r0, n):
                return lib.sed_tier_split(rows.data_ptr(), 1, window.data_ptr(), x, r0, n, 0, 1,
                                          1, *shape, 0, stream)

            def fused():
                for r0, n in kernels.frame_groups(frames, fp["group_frames"]):
                    if split(r0, n) or lib.sed_tier_dft_power(
                            x, tab1.data_ptr(), tab2.data_ptr(), tw.data_ptr(),
                            fused_out[r0:].data_ptr(), n, log2_n, inner, outer, 0, stream):
                        raise RuntimeError(f"the fused route failed at {line}")

            def gemms():
                for r0, n in kernels.frame_groups(frames, gp["group_frames"]):
                    if (split(r0, n)
                            or lib.sed_tier_inner(x, tab1.data_ptr(), tw.data_ptr(), t, n, *shape,
                                                  0, stream)
                            or lib.sed_tier_outer(t, tab2.data_ptr(), gemm_out[r0:].data_ptr(),
                                                  None, n, *shape, 0, stream)):
                        raise RuntimeError(f"the GEMMs' route failed at {line}")

            fused()
            gemms()
            torch.cuda.synchronize()
            peak = gemm_out.abs().amax(dim=1, keepdim=True)
            line["rel_diff"] = float(((fused_out - gemm_out).abs() / peak).max())
            line["fused_ms"], line["gemm_ms"] = [], []
            for key, fn in (("fused_ms", fused), ("gemm_ms", gemms), ("gemm_ms", gemms),
                            ("fused_ms", fused)):
                line[key].append(_median_ms(torch, fn, reps=10, warmup=2))
            print(json.dumps(line), flush=True)
            del scratch
        del rows, fused_out, gemm_out
        torch.cuda.empty_cache()


def variants(names) -> None:
    import torch

    from sed_tpu_torch.configs import SpectrogramConfig
    from sed_tpu_torch.ops import cuda_featurizer as kernels

    src = kernels.SOURCE.read_text()
    builds = {"base": src}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise ValueError(f"variant {name}: its edit does not match featurizer.cu once")
            text = text.replace(old, new)
        builds[name] = text
    tmp = tempfile.mkdtemp(prefix="tier_gemm_sweep_")
    cmds = {}
    for name, text in builds.items():
        path = os.path.join(tmp, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        cmds[name] = [kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                      "-O3", "-shared", "-Xcompiler", "-fPIC", "-DSED_FEATURIZER_GEMM_TIERS_ONLY",
                      "-o", path[:-3] + ".so", path]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(cmds)) as pool:
        done = dict(zip(cmds, pool.map(lambda c: subprocess.run(c, capture_output=True,
                                                                text=True), cmds.values())))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = {}
    for name, d in done.items():
        if d.returncode:
            raise RuntimeError(f"variant {name} does not build:\n{d.stdout}{d.stderr}")
        lib = ctypes.CDLL(cmds[name][-2])
        lib.sed_tier_gemm_plan.argtypes = [i32, i32, i32, i32, i32, i64, ctypes.POINTER(i64)]
        lib.sed_tier_split.argtypes = [vp, i32, vp, vp, i64, i64, i64, i32, i32, i32, i32, i32,
                                       i32, i32, i32, vp]
        lib.sed_tier_inner.argtypes = [vp, vp, vp, vp, i64, i32, i32, i32, i32, i32, i32, vp]
        lib.sed_tier_outer.argtypes = [vp, vp, vp, vp, i64, i32, i32, i32, i32, i32, i32, vp]
        libs[name] = lib
    print(json.dumps({"built": list(libs), "seconds": time.perf_counter() - t0,
                      "smi": _smi()}), flush=True)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for sr in RATES:
        cfg = SpectrogramConfig(working_sample_rate=sr)
        hop, n_fft = cfg.hop_size, cfg.nfft
        waves = _noise(torch, sr, dev)
        window = kernels.stft_window(cfg, dev)
        n_frames = 1 + waves.shape[1] // hop
        frames = waves.shape[0] * n_frames
        shape = (*kernels._gemm_dims(n_fft), 0, 3, 3)
        power = torch.empty((frames, n_fft // 2 + 1), device=dev)
        for name in ["base", *names, "base"]:
            lib = libs[name]
            values = (i64 * len(kernels._GEMM_PLAN_KEYS))()
            if lib.sed_tier_gemm_plan(*shape, frames, values):
                raise RuntimeError(f"variant {name}: sed_tier_gemm_plan failed")
            plan = dict(zip(kernels._GEMM_PLAN_KEYS, values))
            tab1, tab2, tw = kernels._gemm_images(n_fft, False, 2, 2, plan["tab1_rows"],
                                                  plan["tab2_rows"], dev)
            scratch = torch.empty(plan["scratch_bytes"], dtype=torch.uint8, device=dev)
            x, t = scratch.data_ptr(), scratch.data_ptr() + plan["x_bytes"]
            groups = kernels.frame_groups(frames, plan["group_frames"])
            parts = {
                "split": lambda r0, g: lib.sed_tier_split(
                    waves.data_ptr(), 0, window.data_ptr(), x, r0, g, waves.shape[1], n_frames,
                    hop, *shape, 0, stream),
                "inner": lambda r0, g: lib.sed_tier_inner(x, tab1.data_ptr(), tw.data_ptr(), t,
                                                          g, *shape, 0, stream),
                "outer": lambda r0, g: lib.sed_tier_outer(t, tab2.data_ptr(),
                                                          power[r0:].data_ptr(), None, g,
                                                          *shape, 0, stream)}
            if any(call(r0, g) for r0, g in groups for call in parts.values()):
                raise RuntimeError(f"variant {name}: a launch failed")
            out = {"variant": name, "sample_rate": sr, "groups": len(groups)}
            for part, call in parts.items():
                out[part] = _median_ms(torch, lambda: [call(r0, g) for r0, g in groups],
                                       reps=5, warmup=1)
            print(json.dumps(out), flush=True)
            del scratch
        del waves, power
        torch.cuda.empty_cache()


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "turns":
        turns(argv[1])
    elif len(argv) >= 2 and argv[0] in ("times", "build"):
        if argv[0] == "build":
            sys.path.insert(0, argv[1])
            from sed_tpu_torch.ops import cuda_featurizer as kernels

            info = kernels.build()
            print(json.dumps({"tree": argv[1], "build_seconds": info.seconds}), flush=True)
        else:
            print(json.dumps(times(argv[1])), flush=True)
    elif argv and argv[0] == "routes":
        routes()
    elif argv and argv[0] == "variants":
        variants(argv[1:])
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
