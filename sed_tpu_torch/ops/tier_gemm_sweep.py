"""Time the tier GEMMs (the split pass, stage 1, stage 2) on a CUDA card.

Two commands, each printing one JSON line per measurement:

    python -m sed_tpu_torch.ops.tier_gemm_sweep turns PARENT_DIR
    python -m sed_tpu_torch.ops.tier_gemm_sweep variants [variant ...]

``turns`` times this tree's and another checkout's (``PARENT_DIR``, e.g. a
``git archive`` of the parent commit) tier routes at fast on 16 x 60 s of
noise, in four turns (parent, this, this, parent), each tree in a process
of its own after both libraries were built side by side: K1t, K3t
(float32 rows), K5t and K6t at 384 kHz and 1.536 MHz, K1t and K6t at 1
kHz (with a call's host time, nothing synchronised, since the small end is
bound by the host), K6t at 2 kHz, and the peak device memory of the 2^20
K1t call.

``variants`` builds the GEMM object alone (``-DSED_FEATURIZER_GEMM_TIERS_
ONLY``) from ``csrc/featurizer.cu`` and from each named variant of it (a few
edits of its text: lesions that skip a part of a kernel, giving wrong
results, to split a stage's time), side by side, then times each launch of
K1t's route at fast over every frame group at 384 kHz and 1.536 MHz through
the C calls, in turns with the unedited build first and last.  A variant
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
    elif argv and argv[0] == "variants":
        variants(argv[1:])
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
