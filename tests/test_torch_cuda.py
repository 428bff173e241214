"""The CUDA kernels of sed_tpu_torch on the card (marker ``gpu``).

These tests need a CUDA device and ``nvcc``; without a card they skip.  They
import neither JAX nor sed_tpu, so they also run where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Tolerances (against the plain versions computed in float64 on the card):
  * K1 and K3 power, K6's packed Z: abs error <= 1e-5 x the frame's (row's)
    peak, at every n_fft 4..2^20 (above 32768 over a cluster of 2 or 4 CTAs
    a frame, above 131072 a global cross pass into sub-rows of such
    clusters);
  * K2, K5, every impl name and the whole featurizer: <= 1e-4 dB (K2 at
    row counts across its persistent grid, on rows off a 16-byte boundary,
    at every n_fft 4..32768 and at 32,769 and 65,537 bins; every impl at 96
    and 192 kHz);
  * K5 against K1 then K2: equal bit for bit, at every n_fft 4..2^20;
  * the tier kernels (K1t, K3t, K5t, K6t) against their plain versions
    within ``tier_tol``, at n_fft 128..2^20 (K6t 256..2^20, K5t
    2048..2^20; every pass count of each stage);
  * scores, CUDA against CPU: <= 1e-4 abs (another summation order);
  * the windowed per-file path against the whole-recording forward on the
    card, and M5's two stems against each other: <= 1e-4 abs.
"""

import copy

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import torch_flax_ckpt
from sed_tpu_torch.cli import infer as cli
from sed_tpu_torch.configs import SpectrogramConfig, WaveformConfig
from sed_tpu_torch.device_streaming import DeviceStreamingDetector
from sed_tpu_torch.inference import batch_predict_files, make_batch_predictor
from sed_tpu_torch.models.cnn import TRAIN_CHANNEL_AND_POOL, CnnAvgPooling, MobileNetV1
from sed_tpu_torch.models.m5 import M5
from sed_tpu_torch.ops import cuda_featurizer as kernels
from sed_tpu_torch.ops import featurizer
from sed_tpu_torch.ops import mel as mel_ops
from sed_tpu_torch.ops import stft as stft_ops
from sed_tpu_torch.ops.mulaw import mulaw_encode
from sed_tpu_torch.stream_pool import StreamPool
from sed_tpu_torch.utils.precision import full_float32

pytestmark = pytest.mark.gpu

SMALL = SpectrogramConfig(working_sample_rate=8000, time_margin=0.33)
PROD = SpectrogramConfig()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def signals(n_sig, n, sr, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    t = torch.arange(n, device=device) / sr
    noise = 0.3 * torch.randn(n_sig, n, generator=g, device=device)
    freqs = torch.linspace(100.0, sr / 3, n_sig, device=device)[:, None]
    return (noise + 0.5 * torch.sin(2 * np.pi * freqs * t)).float().contiguous()


def check_k1(waves, window, hop, n_fft):
    """K1 on ``waves``: one launch, within 1e-5 x each frame's peak of the
    float64 plain version."""
    before = kernels.LAUNCHES["wave_stft_power"]
    got = kernels.wave_stft_power(waves, window, hop, n_fft)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["wave_stft_power"] == before + 1
    want = kernels.wave_stft_power_plain(waves.double(), window, hop, n_fft)
    n_sig, n = waves.shape
    assert got.shape == want.shape == (n_sig, 1 + n // hop, n_fft // 2 + 1)
    peak = want.amax(dim=-1, keepdim=True)
    assert bool(((got.double() - want).abs() <= 1e-5 * peak).all())


def check_k5(waves, window, hop, n_fft, bands):
    """K5 on ``waves``: one launch, equal bit for bit to K1 then K2."""
    before = kernels.LAUNCHES["wave_stft_mel_log"]
    got = kernels.wave_stft_mel_log(waves, window, hop, n_fft, bands)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["wave_stft_mel_log"] == before + 1
    power = kernels.wave_stft_power(waves, window, hop, n_fft)
    two = kernels.mel_log(power.reshape(-1, n_fft // 2 + 1), bands)
    n_sig, n = waves.shape
    assert got.shape == (n_sig, 1 + n // hop, bands.n_mels)
    assert torch.equal(got.reshape(-1, bands.n_mels), two)
    return got


@pytest.mark.parametrize("cfg,n", [
    (SMALL, 20 * 8000), (SMALL, 20 * 8000 + 1317), (SMALL, 3000), (SMALL, 7),
    (PROD, 3 * 48000 + 11),
])
def test_k1_matches_float64_plain(cuda, cfg, n):
    check_k1(signals(3, n, cfg.working_sample_rate, cuda), kernels.stft_window(cfg, cuda),
             cfg.hop_size, cfg.nfft)


@pytest.mark.parametrize("cfg", [SMALL, PROD])
def test_k2_matches_float64_plain(cuda, cfg):
    g = torch.Generator(device=cuda).manual_seed(1)
    power = torch.rand(37, cfg.freq_bins, generator=g, device=cuda) ** 4 * 1e3
    power[3] = 0.0
    power[5, : cfg.freq_bins // 2] *= 1e-9
    bands = kernels.mel_bands(cfg, cuda)
    before = kernels.LAUNCHES["mel_log"]
    got = kernels.mel_log(power, bands)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mel_log"] == before + 1
    fb64 = torch.from_numpy(mel_ops.mel_filterbank(cfg, np.float64)).to(cuda)
    want = kernels.mel_log_plain(power.double(), fb64)
    assert float((got.double() - want).abs().max()) <= 1e-4
    assert bool((got[3] == -100.0).all())


def check_k2(power, bands, fb64):
    """K2 on ``power``: one launch, within 1e-4 dB of the float64 plain
    version, silent rows at -100 dB."""
    before = kernels.LAUNCHES["mel_log"]
    got = kernels.mel_log(power, bands)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mel_log"] == before + 1
    want = kernels.mel_log_plain(power.double(), fb64)
    assert got.shape == want.shape == (power.shape[0], bands.n_mels)
    assert float((got.double() - want).abs().max()) <= 1e-4
    silent = (power == 0).all(dim=-1)
    assert bool((got[silent] == -100.0).all())
    return got


def k2_power(rows, n_bins, device, seed):
    """(rows, n_bins) power: noise ** 4 over six decades, row 1 silent."""
    g = torch.Generator(device=device).manual_seed(seed)
    power = torch.rand(rows, n_bins, generator=g, device=device) ** 4 * 1e3
    if rows > 1:
        power[1] = 0.0
    return power


@pytest.mark.parametrize("rows", [1, 131, 132, 133, 160, 264, 527, 528, 2912])
def test_k2_row_counts_across_the_persistent_grid(cuda, rows):
    """At the production n_fft: one row; a row for each SM and either side of
    it; the tick's 160 rows; two rows an SM (264, the one-row grid's edge);
    the switch to four rows at a time (528 = 4 x 132); the scoring batch's
    2912 rows, five and a half groups of four a CTA."""
    fb64 = torch.from_numpy(mel_ops.mel_filterbank(PROD, np.float64)).to(cuda)
    check_k2(k2_power(rows, PROD.freq_bins, cuda, rows), kernels.mel_bands(PROD, cuda), fb64)


@pytest.mark.parametrize("rows", [1, 7, 160, 600])
@pytest.mark.parametrize("first", [1, 2, 3])
def test_k2_rows_not_on_a_16_byte_boundary(cuda, first, rows):
    """A view from row ``first`` of a contiguous tensor (a row is 16,385
    floats: row r starts 4r mod 16 bytes past a boundary) up to the last row
    of its allocation: one launch, within the tolerance, and equal bit for
    bit to the same rows copied to an aligned tensor."""
    power = k2_power(first + rows, PROD.freq_bins, cuda, 20 + first)
    view = power[first:]
    assert view.is_contiguous() and view.data_ptr() % 16 == 4 * first
    assert view.data_ptr() + 4 * view.numel() == power.data_ptr() + 4 * power.numel()
    bands = kernels.mel_bands(PROD, cuda)
    fb64 = torch.from_numpy(mel_ops.mel_filterbank(PROD, np.float64)).to(cuda)
    got = check_k2(view, bands, fb64)
    assert torch.equal(got, kernels.mel_log(view.clone(), bands))


@pytest.mark.parametrize("n_fft", [1 << k for k in range(2, 16)])
def test_k2_every_n_fft_matches_float64_plain(cuda, n_fft):
    """Every n_fft of the 64-band filterbank at 8 kHz (3 to 16,385 bins; below
    n_fft ~ 256 many bands are empty: -100 dB), at 37 rows (one row at a
    time) and 600 (four)."""
    bands = bands_at(n_fft, cuda)
    fb64 = torch.from_numpy(mel_ops.mel_filterbank(
        SpectrogramConfig(working_sample_rate=8000, time_margin=n_fft / 16000),
        np.float64)).to(cuda)
    for rows in (37, 600):
        check_k2(k2_power(rows, n_fft // 2 + 1, cuda, n_fft + rows), bands, fb64)


@pytest.mark.parametrize("rows", [160, 2912])
def test_k2_launches_one_kernel_on_the_inputs_device(cuda, rows):
    """One CUDA call of mel_log is one launch of mel_log_kernel and no other
    device work (torch.profiler), at both row paths."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    bands = kernels.mel_bands(PROD, cuda)
    power = k2_power(rows, PROD.freq_bins, cuda, 30)
    kernels.mel_log(power, bands)
    torch.cuda.synchronize()
    before = kernels.LAUNCHES["mel_log"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = kernels.mel_log(power, bands)
        torch.cuda.synchronize()
    assert kernels.LAUNCHES["mel_log"] == before + 1
    on_device = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(on_device) == 1 and "mel_log_kernel" in on_device[0], on_device
    assert out.device == power.device


def pcm_rows(rows, cfg, device, dtype, seed=4):
    """(rows, nfft) frames of tones and noise, one row silent, one quiet."""
    x = signals(rows, cfg.nfft, cfg.working_sample_rate, device, seed).clamp(-1, 1)
    x[3] = 0.0
    x[5] *= 1e-3
    if dtype == "int16":
        return (x * 32767).round().to(torch.int16)
    return x.contiguous()


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("cfg,rows", [(SMALL, 37), (PROD, 160)])
def test_k3_matches_float64_plain(cuda, cfg, rows, dtype):
    x = pcm_rows(rows, cfg, cuda, dtype)
    window = kernels.stft_window(cfg, cuda)
    before = kernels.LAUNCHES["frames_stft_power"]
    got = kernels.frames_stft_power(x, window, cfg.nfft)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["frames_stft_power"] == before + 1
    want = kernels.frames_stft_power_plain(x, window, cfg.nfft, dtype=torch.float64)
    assert got.shape == want.shape == (rows, cfg.freq_bins)
    assert got.dtype == torch.float32
    peak = want.amax(dim=-1, keepdim=True)
    assert bool(((got.double() - want).abs() <= 1e-5 * peak).all())
    assert bool((got[3] == 0.0).all())


def check_k3(x, window, n_fft):
    """K3 on rows ``x``: one launch, within 1e-5 x each row's peak of the
    float64 plain version, silent rows exactly 0, on the rows' device."""
    before = kernels.LAUNCHES["frames_stft_power"]
    got = kernels.frames_stft_power(x, window, n_fft)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["frames_stft_power"] == before + 1
    want = kernels.frames_stft_power_plain(x, window, n_fft, dtype=torch.float64)
    assert got.shape == want.shape == (x.shape[0], n_fft // 2 + 1)
    assert got.dtype == torch.float32 and got.device == x.device
    peak = want.amax(dim=-1, keepdim=True)
    assert bool(((got.double() - want).abs() <= 1e-5 * peak).all())
    silent = (x == 0).all(dim=-1)
    assert bool((got[silent] == 0.0).all())


def k3_rows(rows, n_fft, device, dtype, seed=12):
    """(rows, n_fft) tones and noise in [-1, 1], row 1 silent, as float32 or
    int16 PCM."""
    x = signals(rows, n_fft, 8000, device, seed).clamp(-1, 1)
    if rows > 1:
        x[1] = 0.0
    if dtype == "int16":
        return (x * 32767).round().to(torch.int16)
    return x.contiguous()


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("n_fft", [1 << k for k in range(2, 16)])
def test_k3_every_n_fft_matches_float64_plain(cuda, n_fft, dtype):
    """Every n_fft K3 takes (4..32768: log2 m 1..14, one template instance
    each), with a window that is zero at both ends."""
    window = torch.from_numpy(stft_ops.padded_window(n_fft - n_fft // 8, n_fft).copy()).to(cuda)
    check_k3(k3_rows(5, n_fft, cuda, dtype), window, n_fft)


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("rows", [1, 131, 132, 133, 160])
def test_k3_row_counts_across_the_wave_edge(cuda, rows, dtype):
    """One row, one wave of 132 SMs and either side of it, and the 32-slot
    tick's 160 rows, at the production n_fft."""
    check_k3(k3_rows(rows, PROD.nfft, cuda, dtype, seed=13), kernels.stft_window(PROD, cuda),
             PROD.nfft)


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("rows", [1, 5])
def test_k3_rows_at_an_odd_element_offset(cuda, rows, dtype):
    """A contiguous view that starts at an odd element (one row cut from a
    flat signal, rows viewed out of a flat buffer) is not aligned to K3's
    pair loads: it goes through one launch all the same, within the
    tolerance and equal to the same rows aligned, and the device stays
    usable."""
    x = k3_rows(rows, SMALL.nfft, cuda, dtype, seed=15)
    flat = torch.zeros(rows * SMALL.nfft + 1, dtype=x.dtype, device=cuda)
    flat[1:] = x.reshape(-1)
    view = flat[1:].view(rows, SMALL.nfft)
    assert view.is_contiguous() and view.data_ptr() % (2 * view.element_size())
    window = kernels.stft_window(SMALL, cuda)
    check_k3(view, window, SMALL.nfft)
    assert torch.equal(kernels.frames_stft_power(view, window, SMALL.nfft),
                       kernels.frames_stft_power(x, window, SMALL.nfft))
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_k3_launches_one_kernel_on_the_inputs_device(cuda, dtype):
    """One CUDA call of frames_stft_power is one launch of the Stockham-core
    frames_stft_power_kernel (torch.profiler); float32 rows run no other
    device work, int16 rows only the window's 1/32768 scaling."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = k3_rows(160, PROD.nfft, cuda, dtype, seed=14)
    window = kernels.stft_window(PROD, cuda)
    kernels.frames_stft_power(x, window, PROD.nfft)   # tables cached
    torch.cuda.synchronize()
    before = kernels.LAUNCHES["frames_stft_power"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = kernels.frames_stft_power(x, window, PROD.nfft)
        torch.cuda.synchronize()
    assert kernels.LAUNCHES["frames_stft_power"] == before + 1
    on_device = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    k3 = [n for n in on_device if "frames_stft_power_kernel" in n]
    assert len(k3) == 1, on_device
    assert len(on_device) == (1 if dtype == "float32" else 2), on_device
    assert out.device == x.device


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_logmel_frames_cuda_matches_cpu_and_float64(cuda, dtype):
    x = pcm_rows(29, SMALL, cuda, dtype, seed=6)
    got = featurizer.logmel_frames(x, SMALL)
    torch.cuda.synchronize()
    want = featurizer.logmel_frames(x.cpu(), SMALL)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    window = kernels.stft_window(SMALL, cuda)
    fb64 = torch.from_numpy(mel_ops.mel_filterbank(SMALL, np.float64)).to(cuda)
    chain = kernels.mel_log_plain(
        kernels.frames_stft_power_plain(x, window, SMALL.nfft, dtype=torch.float64), fb64)
    assert float((got.double() - chain).abs().max()) <= 1e-4


def test_stream_pool_cuda_matches_cpu(cuda):
    """A 2-slot pool on the card and on the CPU, fed the same uneven int16
    pieces: same blocks, scores within 1e-4; the card's run went through K3
    and K2."""
    model = CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL,
                          generator=torch.Generator().manual_seed(0))
    cpu_model = CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL)
    cpu_model.load_state_dict(model.state_dict())
    audio = (signals(2, 14 * 8000 + 321, 8000, cuda, seed=7).clamp(-1, 1) * 32767)
    audio = audio.to(torch.int16).cpu().numpy()
    kw = dict(slots=2, chunk_samples=8000, halo=64, total_stride=8, bucket=64)
    outs = {}
    for name, m, device in (("card", model, cuda), ("cpu", cpu_model, "cpu")):
        kernels.reset_launch_counts()
        pool = StreamPool(m, SMALL, device=device, **kw)
        slots = [pool.join() for _ in audio]
        blocks = {s: [] for s in slots}
        for lo, hi in ((0, 5000), (5000, 40000), (40000, 100000), (100000, None)):
            for s, y in zip(slots, audio):
                pool.feed(s, y[lo:hi])
            for s, sc in pool.tick().items():
                blocks[s].append(sc)
        for s in slots:
            blocks[s].append(pool.leave(s))
        outs[name] = [np.concatenate(blocks[s]) for s in slots]
        if name == "card":
            assert kernels.LAUNCHES["frames_stft_power"] > 0
            assert kernels.LAUNCHES["mel_log"] > 0
        else:
            assert sum(kernels.LAUNCHES.values()) == 0
    for got, want in zip(outs["card"], outs["cpu"]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_device_detector_cuda_matches_cpu(cuda):
    """The lockstep device-ring detector on the card and on the CPU, int16
    chunks: same blocks, scores within 1e-4."""
    model = CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL,
                          generator=torch.Generator().manual_seed(1))
    cpu_model = CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL)
    cpu_model.load_state_dict(model.state_dict())
    audio = (signals(2, 12 * 8000, 8000, cuda, seed=8).clamp(-1, 1) * 32767)
    audio = audio.to(torch.int16).cpu().numpy()
    kw = dict(batch=2, chunk_samples=8000, halo=64, total_stride=8, bucket=64)
    outs = {}
    for name, m, device in (("card", model, cuda), ("cpu", cpu_model, "cpu")):
        kernels.reset_launch_counts()
        det = DeviceStreamingDetector(m, SMALL, device=device, **kw)
        blocks = [det.push(audio[:, i:i + 8000]) for i in range(0, audio.shape[1], 8000)]
        outs[name] = np.concatenate(blocks + [det.flush()], axis=1)
        assert det._device_mode
        launched = kernels.LAUNCHES["frames_stft_power"] > 0
        assert launched == (name == "card")
    assert outs["card"].shape == outs["cpu"].shape
    np.testing.assert_allclose(outs["card"], outs["cpu"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "int16", "uint8"])
def test_featurizer_cuda_matches_cpu(cuda, dtype):
    x = signals(2, 10 * 8000, 8000, cuda, seed=2).clamp(-1, 1).cpu().numpy()
    if dtype == "int16":
        x = (x * 32767).astype(np.int16)
    elif dtype == "uint8":
        x = mulaw_encode(x)
    x = torch.from_numpy(x)[..., None]
    got = featurizer.logmel_features_batch(x.to(cuda), SMALL).cpu()
    want = featurizer.logmel_features_batch(x, SMALL)
    assert got.shape == want.shape == (2, 1, 31, 64)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    window = kernels.stft_window(SMALL, cuda)
    waves = signals(2, 9000, 8000, cuda)
    with pytest.raises(TypeError):
        kernels.wave_stft_power(waves.double(), window, SMALL.hop_size, SMALL.nfft)
    with pytest.raises(ValueError):
        kernels.wave_stft_power(waves.t(), window, SMALL.hop_size, SMALL.nfft)
    with pytest.raises(ValueError):
        kernels.wave_stft_power(waves, window[:-1].contiguous(), SMALL.hop_size,
                                SMALL.nfft)
    with pytest.raises(ValueError):
        kernels.wave_stft_power(waves, window.cpu(), SMALL.hop_size, SMALL.nfft)
    # Up to n_fft 2^20 (1.536 MHz), the largest the kernels take.
    big = torch.zeros(1 << 21, device=cuda)
    with pytest.raises(ValueError, match="exceeds 1048576"):
        kernels.wave_stft_power(waves, big, 1000, 1 << 21)
    bands = kernels.mel_bands(SMALL, cuda)
    with pytest.raises(ValueError):
        kernels.mel_log(torch.zeros(4, SMALL.freq_bins - 1, device=cuda), bands)
    with pytest.raises(TypeError):
        kernels.mel_log(torch.zeros(4, SMALL.freq_bins, device=cuda,
                                    dtype=torch.float16), bands)
    rows = torch.zeros(4, SMALL.nfft, device=cuda)
    with pytest.raises(TypeError):
        kernels.frames_stft_power(rows.double(), window, SMALL.nfft)
    with pytest.raises(ValueError):
        kernels.frames_stft_power(rows[:, :-1], window, SMALL.nfft)
    with pytest.raises(ValueError):
        kernels.frames_stft_power(torch.zeros(8, SMALL.nfft, device=cuda)[::2],
                                  window, SMALL.nfft)
    with pytest.raises(ValueError):
        kernels.frames_stft_power(rows, window.cpu(), SMALL.nfft)


WRAPPER_CALLS = {
    "wave_stft_power": lambda w, win, b: kernels.wave_stft_power(
        w, win, SMALL.hop_size, SMALL.nfft),
    "mel_log": lambda w, win, b: kernels.mel_log(
        torch.zeros(4, SMALL.freq_bins, device=w.device), b),
    "frames_stft_power": lambda w, win, b: kernels.frames_stft_power(
        w[:, :SMALL.nfft].contiguous(), win, SMALL.nfft),
    "wave_stft_mel_log": lambda w, win, b: kernels.wave_stft_mel_log(
        w, win, SMALL.hop_size, SMALL.nfft, b),
    "wave_packed_fft": lambda w, win, b: kernels.wave_packed_fft(
        w, win, SMALL.hop_size, SMALL.nfft),
}


@pytest.mark.parametrize("name", sorted(WRAPPER_CALLS))
def test_wrapper_leaves_the_current_device_as_it_found_it(cuda, name):
    """A wrapper called on the last device while device 0 is current
    launches there and leaves device 0 current (the C entry points'
    DeviceGuard).  It needs two devices, so it skips on a one-card machine,
    such as the H100 the smoke run uses; tests/test_torch_device_guard.py
    checks the guard in the source on any machine."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    torch.cuda.set_device(0)
    waves = signals(2, 9000, 8000, last)
    window = kernels.stft_window(SMALL, last)
    bands = kernels.mel_bands(SMALL, last)
    before = kernels.LAUNCHES[name]
    WRAPPER_CALLS[name](waves, window, bands)
    torch.cuda.synchronize(last)
    assert kernels.LAUNCHES[name] == before + 1
    assert torch.cuda.current_device() == 0
    assert torch.empty(1, device="cuda").device.index == 0


def test_predictor_and_files_cuda_match_cpu(cuda, tmp_path):
    from scipy.io import wavfile

    model = CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL,
                          generator=torch.Generator().manual_seed(0))
    cpu_model = CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL)
    cpu_model.load_state_dict(model.state_dict())
    x = (signals(3, 5 * 48000, 48000, cuda, seed=3).clamp(-1, 1) * 32767)
    x = x.to(torch.int16)[..., None]
    kernels.reset_launch_counts()
    got = make_batch_predictor(model, PROD, device=cuda)(x).cpu()
    assert kernels.LAUNCHES == {"wave_stft_power": 1, "mel_log": 1,
                                "frames_stft_power": 0, "wave_stft_mel_log": 0,
                                "wave_packed_fft": 0, "wave_dft_power_bf16": 0,
                                "frames_dft_power_bf16": 0, "mel_log_bf16": 0,
                                "wave_stft_mel_log_mel_bf16": 0, "wave_stft_mel_log_bf16": 0,
                                "wave_packed_fft_bf16": 0, "fft_cross_pass": 0, "fft_subrows": 0,
                                "packed_power": 0, "tier_split": 0, "tier_inner": 0,
                                "tier_outer": 0}
    want = make_batch_predictor(cpu_model, PROD, device="cpu")(x.cpu())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)

    paths = []
    for i, n in enumerate([5 * 48000, 4 * 48000, 5 * 48000]):
        path = tmp_path / f"c{i}.wav"
        wavfile.write(path, 48000, x[i % 3, :n, 0].cpu().numpy())
        paths.append(str(path))
    on_card = batch_predict_files(model, paths, PROD, device=cuda)
    on_cpu = batch_predict_files(cpu_model, paths, PROD, device="cpu")
    for p in paths:
        np.testing.assert_allclose(on_card[p], on_cpu[p], rtol=0, atol=1e-4)


@pytest.mark.parametrize("cfg,n", [
    (SMALL, 20 * 8000), (SMALL, 20 * 8000 + 1317), (SMALL, 7), (PROD, 3 * 48000 + 11),
])
def test_k5_equals_k1_then_k2_and_float64(cuda, cfg, n):
    """K5 is K1 then K2 in one launch: equal bit for bit.  Against the
    float64 chain: every band's mel power within 1e-5 of its frame's loudest
    band (K1's power tolerance), and 1e-4 dB on every band within 60 dB of
    its frame's loudest."""
    waves = signals(3, n, cfg.working_sample_rate, cuda)
    window = kernels.stft_window(cfg, cuda)
    bands = kernels.mel_bands(cfg, cuda)
    got = check_k5(waves, window, cfg.hop_size, cfg.nfft, bands)
    fb64 = torch.from_numpy(mel_ops.mel_filterbank(cfg, np.float64)).to(cuda)
    want = kernels.wave_stft_mel_log_plain(waves.double(), window, cfg.hop_size,
                                           cfg.nfft, fb64)
    loudest = want.amax(dim=-1, keepdim=True)
    peak_power = 10.0 ** (loudest / 10)
    power_err = (10.0 ** (got.double() / 10) - 10.0 ** (want / 10)).abs()
    assert bool((power_err <= 1e-5 * peak_power).all())
    audible = want >= loudest - 60.0
    assert float((got.double() - want)[audible].abs().max()) <= 1e-4
    if n >= cfg.nfft:
        assert bool(audible.all())
    else:
        # 7 samples reflected into a whole frame: a few harmonics, and bands
        # ~140 dB below them, where float32's FFT error (~1e-7 of the frame
        # peak) is most of their power.  cuFFT in float32 misses there too.
        quiet = ~audible
        assert bool(quiet.any())
        cufft32 = kernels.wave_stft_mel_log_plain(waves, window, cfg.hop_size,
                                                  cfg.nfft, bands.dense)
        assert float((cufft32.double() - want)[quiet].abs().max()) > 1e-4


def _k6_cases():
    """(n_fft, hop, window length, n_signals, n): the configs' cases, then
    every n_fft K6 takes (4..32768, m = 2..16384) with a hop that does not
    divide it: an odd length of 3 signals over both reflection edges and
    interior frames (odd n_samples: every other signal's base is not 8-byte
    aligned), a signal shorter than half a frame, and a single sample."""
    cases = [(cfg.nfft, cfg.hop_size, cfg.frame_size, 3, n) for cfg, n in (
        (SMALL, 20 * 8000 + 1317), (SMALL, 7), (PROD, 3 * 48000 + 11))]
    for log2_n in range(2, 16):
        n_fft = 1 << log2_n
        hop, win = max(1, 3 * n_fft // 8), n_fft - n_fft // 8
        cases += [(n_fft, hop, win, 3, 3 * n_fft + 11),
                  (n_fft, hop, win, 1, max(1, n_fft // 2 - 3)),
                  (n_fft, hop, win, 2, 1)]
    return cases


@pytest.mark.parametrize("n_fft,hop,win,n_sig,n", _k6_cases())
def test_k6_matches_float64_plain(cuda, n_fft, hop, win, n_sig, n):
    waves = signals(n_sig, n, 8000, cuda)
    window = torch.from_numpy(stft_ops.padded_window(win, n_fft).copy()).to(cuda)
    before = kernels.LAUNCHES["wave_packed_fft"]
    zr, zi = kernels.wave_packed_fft(waves, window, hop, n_fft)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["wave_packed_fft"] == before + 1
    wr, wi = kernels.wave_packed_fft_plain(waves.double(), window, hop, n_fft)
    assert zr.shape == zi.shape == wr.shape == (n_sig, 1 + n // hop, n_fft // 2)
    peak = torch.hypot(wr, wi).amax(dim=-1, keepdim=True)
    assert bool(((zr.double() - wr).abs() <= 1e-5 * peak).all())
    assert bool(((zi.double() - wi).abs() <= 1e-5 * peak).all())


def test_k6_launches_one_kernel_on_the_inputs_device(cuda):
    """One CUDA call of wave_packed_fft is one launch of
    wave_packed_fft_kernel and no other device work (torch.profiler), and
    both outputs lie on the waveform's device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    waves = signals(2, 5 * 48000 + 3, 48000, cuda)
    window = kernels.stft_window(PROD, cuda)
    kernels.wave_packed_fft(waves, window, PROD.hop_size, PROD.nfft)   # tables cached
    torch.cuda.synchronize()
    before = kernels.LAUNCHES["wave_packed_fft"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        zr, zi = kernels.wave_packed_fft(waves, window, PROD.hop_size, PROD.nfft)
        torch.cuda.synchronize()
    assert kernels.LAUNCHES["wave_packed_fft"] == before + 1
    on_device = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(on_device) == 1 and "wave_packed_fft_kernel" in on_device[0], on_device
    assert zr.device == zi.device == waves.device


def bands_at(n_fft, device):
    """K2's bands of the 64-band Slaney filterbank of n_fft at 8 kHz (below
    n_fft ~ 256 many bands cover no bin: -100 dB)."""
    cfg = SpectrogramConfig(working_sample_rate=8000, time_margin=n_fft / 16000)
    assert cfg.nfft == n_fft
    return kernels.mel_bands(cfg, device)


@pytest.mark.parametrize("n_fft,hop,win,n_sig,n", _k6_cases())
def test_k1_every_n_fft_matches_float64_plain(cuda, n_fft, hop, win, n_sig, n):
    """Every n_fft K1 takes (4..32768: log2 m 1..14, one template instance
    each) on K6's cases: odd lengths over both reflection edges, signals
    shorter than half a frame, a single sample."""
    window = torch.from_numpy(stft_ops.padded_window(win, n_fft).copy()).to(cuda)
    check_k1(signals(n_sig, n, 8000, cuda), window, hop, n_fft)


@pytest.mark.parametrize("n_fft,hop,win,n_sig,n", _k6_cases())
def test_k5_every_n_fft_equals_k1_then_k2(cuda, n_fft, hop, win, n_sig, n):
    """K5 at every n_fft: below n_fft 1024 its CTA has fewer than 32 threads
    and each thread sums whole bands, in K2's warp order."""
    window = torch.from_numpy(stft_ops.padded_window(win, n_fft).copy()).to(cuda)
    check_k5(signals(n_sig, n, 8000, cuda), window, hop, n_fft, bands_at(n_fft, cuda))


@pytest.mark.parametrize("kernel", ["k1", "k5"])
@pytest.mark.parametrize("n_sig,n,frames", [
    (1, 130 * PROD.hop_size, 131), (1, 131 * PROD.hop_size + 7, 132),
    (1, 132 * PROD.hop_size, 133), (16, 60 * 48000, 2912),
    (3, 40 * PROD.hop_size + 11, 123),
])
def test_k1_and_k5_frame_counts_across_the_wave_edge(cuda, kernel, n_sig, n, frames):
    """At the production n_fft: one wave of 132 SMs and either side of it,
    the scoring batch's 16 x 60 s, and an odd n_sig * n_samples (every other
    signal's base not 8-byte aligned)."""
    assert n_sig * (1 + n // PROD.hop_size) == frames
    waves = signals(n_sig, n, PROD.working_sample_rate, cuda, seed=16)
    window = kernels.stft_window(PROD, cuda)
    if kernel == "k1":
        check_k1(waves, window, PROD.hop_size, PROD.nfft)
    else:
        check_k5(waves, window, PROD.hop_size, PROD.nfft, kernels.mel_bands(PROD, cuda))


@pytest.mark.parametrize("name", ["wave_stft_power", "wave_stft_mel_log"])
def test_k1_and_k5_launch_one_kernel_on_the_inputs_device(cuda, name):
    """One CUDA call of wave_stft_power (wave_stft_mel_log) is one launch of
    the Stockham-core wave_stft_power_kernel (wave_stft_mel_log_kernel) and
    no other device work (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    waves = signals(2, 5 * 48000 + 3, 48000, cuda)
    window = kernels.stft_window(PROD, cuda)
    bands = kernels.mel_bands(PROD, cuda)
    args = (waves, window, PROD.hop_size, PROD.nfft) + ((bands,) if name == "wave_stft_mel_log"
                                                         else ())
    fn = getattr(kernels, name)
    fn(*args)   # tables cached
    torch.cuda.synchronize()
    before = kernels.LAUNCHES[name]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn(*args)
        torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    on_device = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(on_device) == 1 and f"{name}_kernel" in on_device[0], on_device
    assert out.device == waves.device


@pytest.mark.parametrize("name", ["k5t", "k5b", "k6t"])
def test_k5t_k5b_k6t_launch_one_kernel(cuda, name):
    """One CUDA call of K5b's and K6t's wrappers is one launch of its kernel
    and no other device work (torch.profiler); K5t's is K1t's route, the
    split pass and one launch of the fused kernel (counted under K5t's
    name), then K2.  It runs beside K1's, K5's and K6's: at
    the end of a whole run of this file the profiler caught no device event
    at all (PERF.md §7)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    waves = signals(2, 5 * 48000 + 3, 48000, cuda)
    window, bands = kernels.stft_window(PROD, cuda), kernels.mel_bands(PROD, cuda)
    hop, n_fft = PROD.hop_size, PROD.nfft
    counter, kernel, call = {
        "k5t": ("wave_stft_mel_log_bf16", "tier_fused_kernel",
                lambda: kernels.wave_stft_mel_log_bf16(waves, window, hop, n_fft, bands,
                                                       "bf16x3", "bf16x1")),
        "k5b": ("wave_stft_mel_log_mel_bf16", "wave_stft_mel_log_kernel",
                lambda: kernels.wave_stft_mel_log(waves, window, hop, n_fft, bands, "bf16x3")),
        "k6t": ("wave_packed_fft_bf16", "tier_packed_fft_kernel",
                lambda: kernels.wave_packed_fft_bf16(waves, window, hop, n_fft, "bf16x1")),
    }[name]
    call()   # tables cached
    torch.cuda.synchronize()
    before = kernels.LAUNCHES[counter]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = call()
        torch.cuda.synchronize()
    assert kernels.LAUNCHES[counter] == before + 1
    on_device = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    if name == "k5t":
        assert len(on_device) == 3 and "tier_split_kernel" in on_device[0], on_device
        assert "mel_log_kernel" in on_device[2], on_device
        on_device = on_device[1:2]
    assert len(on_device) == 1 and kernel in on_device[0], on_device
    assert all(t.device == waves.device for t in (out if isinstance(out, tuple) else (out,)))


@pytest.mark.parametrize("impl", sorted(kernels.IMPL_KERNELS))
def test_every_impl_launches_its_kernels(cuda, impl):
    """Each sed_tpu impl name on the card: exactly the kernels its row names,
    once each; within 1e-4 dB of the float64 chain and of the CPU."""
    cfg, n = ((PROD, 6 * 48000) if impl in ("rollraw", "rolledge")
              else (SMALL, 20 * 8000 + 1317))
    waves = signals(2, n, cfg.working_sample_rate, cuda)
    kernels.reset_launch_counts()
    got = kernels.logmel_waveform(waves, cfg, impl=impl)
    torch.cuda.synchronize()
    want_launches = dict.fromkeys(kernels.LAUNCHES, 0)
    want_launches.update(dict.fromkeys(kernels.IMPL_KERNELS[impl], 1))
    assert kernels.LAUNCHES == want_launches
    window = kernels.stft_window(cfg, cuda)
    fb64 = torch.from_numpy(mel_ops.mel_filterbank(cfg, np.float64)).to(cuda)
    chain = kernels.wave_stft_mel_log_plain(waves.double(), window, cfg.hop_size,
                                            cfg.nfft, fb64)
    assert got.shape == chain.shape
    assert float((got.double() - chain).abs().max()) <= 1e-4
    on_cpu = kernels.logmel_waveform(waves.cpu(), cfg, impl=impl)
    torch.testing.assert_close(got.cpu(), on_cpu, rtol=0, atol=1e-4)


@pytest.mark.parametrize("fft_impl", ["fft", "matmul"])
def test_use_pallas_paths_on_the_card(cuda, fft_impl):
    """use_pallas=True: the STFT in PyTorch, then K4 (the mel kernel) only;
    False: PyTorch ops only; 'auto': K1 + K2.  All three agree with the CPU."""
    x = (signals(2, 10 * 8000, 8000, cuda, seed=9).clamp(-1, 1) * 32767).to(torch.int16)
    x = x.T[None].contiguous()
    for use_pallas, launched in ((True, {"mel_log": 1}), (False, {}),
                                 ("auto", {"wave_stft_power": 1, "mel_log": 1})):
        kernels.reset_launch_counts()
        got = featurizer.logmel_features_batch(x, SMALL, fft_impl=fft_impl,
                                               use_pallas=use_pallas)
        torch.cuda.synchronize()
        assert {k: v for k, v in kernels.LAUNCHES.items() if v} == launched
        want = featurizer.logmel_features_batch(x.cpu(), SMALL, fft_impl=fft_impl,
                                                use_pallas=use_pallas)
        assert got.shape == want.shape == (1, 2, 31, 64)
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


def test_k4_streamed_filterbank_config_on_the_card(cuda):
    """K4 at n_fft 131072 (65537 bins), where sed_tpu streams its 33.6 MB
    filterbank: K2 takes the bins as they are, within 1e-4 dB of float64."""
    cfg = SpectrogramConfig(time_margin=0.7)
    assert cfg.freq_bins == 65537
    g = torch.Generator(device=cuda).manual_seed(10)
    power = torch.rand(3, 2, cfg.freq_bins, generator=g, device=cuda) ** 4 * 1e3
    power[1, 0] = 0.0
    kernels.reset_launch_counts()
    got = kernels.power_to_logmel_cuda(power, cfg)
    torch.cuda.synchronize()
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {"mel_log": 1}
    fb64 = torch.from_numpy(mel_ops.mel_filterbank(cfg, np.float64)).to(cuda)
    want = kernels.mel_log_plain(power.double(), fb64)
    assert got.shape == want.shape == (3, 2, 64)
    assert float((got.double() - want).abs().max()) <= 1e-4
    assert bool((got[1, 0] == -100.0).all())


def test_multichannel_stft_host_runs_on_the_card(cuda, monkeypatch):
    """A numpy waveform is transformed on the card by default, and the host
    array equals multichannel_stft's on the same device."""
    wav = signals(3, 2 * 8000, 8000, cuda, seed=11).T.contiguous()     # (samples, 3)
    seen = []
    realimag = stft_ops.stft_realimag

    def spy(y, *args):
        seen.append(y.device.type)
        return realimag(y, *args)

    monkeypatch.setattr(stft_ops, "stft_realimag", spy)
    host = featurizer.multichannel_stft_host(wav.cpu().numpy(), SMALL, "fft")
    assert seen == ["cuda"]
    spec = featurizer.multichannel_stft(wav, SMALL, "fft").cpu().numpy()
    assert host.dtype == spec.dtype == np.complex64
    np.testing.assert_array_equal(host, spec)


def test_new_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    window = kernels.stft_window(SMALL, cuda)
    waves = signals(2, 9000, 8000, cuda)
    bands = kernels.mel_bands(SMALL, cuda)
    with pytest.raises(TypeError):
        kernels.wave_packed_fft(waves.double(), window, SMALL.hop_size, SMALL.nfft)
    with pytest.raises(ValueError):
        kernels.wave_packed_fft(waves.t(), window, SMALL.hop_size, SMALL.nfft)
    with pytest.raises(ValueError):
        kernels.wave_stft_mel_log(waves, window.cpu(), SMALL.hop_size, SMALL.nfft, bands)
    with pytest.raises(ValueError, match="bins"):
        kernels.wave_stft_mel_log(waves, window, SMALL.hop_size, SMALL.nfft,
                                  kernels.mel_bands(PROD, cuda))
    with pytest.raises(ValueError):
        kernels.wave_stft_mel_log(waves, window, SMALL.hop_size, SMALL.nfft,
                                  kernels.mel_bands(SMALL, torch.device("cpu")))
    # K5 fuses up to 131072 and chains K1 and K2 up to 2^20; not above it.
    big = torch.zeros(1 << 21, device=cuda)
    with pytest.raises(ValueError, match="exceeds 1048576"):
        kernels.wave_stft_mel_log(waves, big, 1000, 1 << 21, bands)


def seeded_model(arch, seed=0):
    """``arch`` with seeded weights and seeded BatchNorm statistics."""
    g = torch.Generator().manual_seed(seed)
    model = {"CnnAvgPooling": lambda: CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL, generator=g),
             "MobileNetV1": lambda: MobileNetV1(1, generator=g),
             "M5": lambda: M5(1, generator=g)}[arch]()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                m.running_mean.uniform_(-0.5, 0.5, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
                m.bias.uniform_(-0.3, 0.3, generator=g)
    return model.eval()


def burst_wav(path, seconds, sr=48000, seed=0):
    """Noise with tonal bursts, int16."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    burst = (np.sin(2 * np.pi * 0.05 * t) > 0.6) * np.sin(2 * np.pi * 2000.0 * t)
    x = np.clip(0.2 * rng.standard_normal(t.size) + 0.5 * burst, -1, 1)
    wavfile.write(path, sr, (x * 32767).astype(np.int16))
    return str(path)


@pytest.mark.parametrize("arch,window,halo", [("CnnAvgPooling", 64, 32),
                                              ("MobileNetV1", 64, 64)])
def test_predict_file_windowed_equals_whole_forward_on_the_card(cuda, tmp_path, arch,
                                                                window, halo):
    """Several windows and a ragged tail (91.3 s: 277 frames); one K1 and
    one K2 launch per file."""
    path = burst_wav(tmp_path / "long.wav", 91.3, seed=1)
    model = seeded_model(arch, seed=2)
    kernels.reset_launch_counts()
    log_mel, got = cli.predict_file(model, path, PROD, window=window, halo=halo,
                                    device="cuda")
    torch.cuda.synchronize()
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {"wave_stft_power": 1,
                                                                "mel_log": 1}
    assert log_mel.device.type == "cuda" and log_mel.shape == (1, 277, 64)
    with torch.inference_mode(), full_float32():   # predict_file's precision
        whole = model(log_mel[None])[0]
        whole = whole if arch == "MobileNetV1" else torch.sigmoid(whole)
    assert got.shape == tuple(whole.shape) == (272, 1)
    assert float(np.abs(got - whole.cpu().numpy()).max()) <= 1e-4


@pytest.mark.parametrize("arch", ["CnnAvgPooling", "MobileNetV1", "M5"])
def test_per_file_paths_cuda_match_cpu(cuda, tmp_path, arch):
    path = burst_wav(tmp_path / "clip.wav", 75.0, seed=3)
    model = seeded_model(arch, seed=4)
    cpu_model = copy.deepcopy(model)
    if arch == "M5":
        got = cli.predict_file_m5(model, path, WaveformConfig(), device="cuda")
        want = cli.predict_file_m5(cpu_model, path, WaveformConfig(), device="cpu")
    else:
        _, got = cli.predict_file(model, path, PROD, window=64, halo=64, device="cuda")
        _, want = cli.predict_file(cpu_model, path, PROD, window=64, halo=64, device="cpu")
    assert got.shape == want.shape and got.shape[0] > 0
    assert float(np.abs(got - want).max()) <= 1e-4


def test_m5_stems_agree_on_the_card(cuda):
    direct = seeded_model("M5", seed=5).to(cuda)
    s2d = M5(1, conv1_s2d=True)
    s2d.load_state_dict(direct.state_dict(), strict=True)
    s2d = s2d.to(cuda).eval()
    x = signals(40, WaveformConfig().frame_size, 48000, cuda, seed=6)[:, None]
    with torch.inference_mode(), full_float32():
        a, b = torch.sigmoid(direct(x)), torch.sigmoid(s2d(x))
    assert float((a - b).abs().max()) <= 1e-4


def test_m5_framing_on_the_card_equals_the_host(cuda):
    cfg = WaveformConfig()
    wav = signals(2, 7 * cfg.frame_size + 123, 48000, cuda, seed=7).T.contiguous()
    got = cli.hop_frames(wav, cfg)
    want = cli.hop_frames(wav.cpu(), cfg)
    assert got.device.type == "cuda" and got.shape == want.shape == (13, 2, cfg.frame_size)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got[3, 1], wav[3 * cfg.hop_size: 3 * cfg.hop_size + cfg.frame_size, 1])


def test_mobilenet_batch_predictor_cuda_matches_cpu(cuda):
    model = seeded_model("MobileNetV1", seed=8)
    cpu_model = copy.deepcopy(model)
    x = signals(2, 10 * 48000, 48000, cuda, seed=9)[..., None]
    got = make_batch_predictor(model, PROD, device="cuda")(x)
    want = make_batch_predictor(cpu_model, PROD, device="cpu")(x.cpu())
    assert got.shape == want.shape == (2, 24, 1)
    assert float((got.cpu() - want).abs().max()) <= 1e-4


# ---------------------------------------------------------------------------
# Training (slice B): the train step, train-mode BatchNorm, checkpoints.
# Tolerances: card against CPU in float64, losses within 1e-9 relative and
# parameters, statistics and gradients within 1e-9 of each tensor's largest
# (in float32 the card's BatchNorm backward sums in float32 and its
# gradients part from float64 by up to ~4e-3 of a tensor's largest, the
# CPU's by ~6e-6, and Adam's sign-like first update carries that into
# later steps); in float32 the first loss within 1e-4 relative; running
# statistics within 1e-6.
# ---------------------------------------------------------------------------

class _TrainStore:
    """A packed training split like SpectrogramDataset's."""

    def __init__(self, complex_mode, cfg, frames=200, seed=0):
        rng = np.random.default_rng(seed)
        bins = cfg.freq_bins if complex_mode else cfg.mel_bins
        shape = (1, frames, bins)
        f = rng.standard_normal(shape).astype(np.float32)
        if complex_mode:
            f = (f + 1j * rng.standard_normal(shape)).astype(np.complex64)
        self.train_features = f
        self.train_event_matrix = (rng.random((frames, 1)) > 0.7).astype(np.float32)
        self.train_start_indices = rng.permutation(frames - cfg.train_crop_size).astype(np.int32)
        self.mean = f.mean(axis=(0, 1))
        self.std = f.std(axis=(0, 1))


def _buffers(store, device, dtype):
    import dataclasses

    from sed_tpu_torch.data import device_pipeline as pipe

    b = pipe.spectrogram_buffers_from_dataset(store, device)
    return dataclasses.replace(b, features=b.features.to(dtype), events=b.events.to(dtype),
                               mean=b.mean.to(dtype), std=b.std.to(dtype))


@pytest.mark.parametrize("mode", ["logMel", "Complex"])
def test_train_step_on_the_card_matches_cpu(cuda, mode):
    from sed_tpu_torch.data import device_pipeline as pipe
    from sed_tpu_torch.train.state import init_state

    store = _TrainStore(mode == "Complex", SMALL)
    starts = store.train_start_indices[:16]
    step = pipe.make_spectrogram_train_step(SMALL, 5.0, mode, augment=False)
    base = CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL, generator=torch.Generator().manual_seed(0))
    runs = {}
    for dev in ("cpu", cuda):
        for dtype in (torch.float64, torch.float32):
            state = init_state(copy.deepcopy(base).to(dtype), 1e-3, dev)
            bufs = _buffers(store, dev, dtype)
            losses, grads = [], None
            for i in range(3 if dtype == torch.float64 else 1):
                losses.append(float(step(state, bufs, starts)))
                if i == 0:
                    grads = {k: p.grad.cpu() for k, p in state.model.named_parameters()}
            runs[str(dev), dtype] = (losses, grads, {k: v.detach().cpu() for k, v in
                                                     state.model.state_dict().items()})
    cpu, gpu = runs["cpu", torch.float64], runs[str(cuda), torch.float64]
    np.testing.assert_allclose(gpu[0], cpu[0], rtol=1e-9)
    for mine, theirs in ((gpu[1], cpu[1]), (gpu[2], cpu[2])):
        for key, want in theirs.items():
            scale = max(want.abs().max().item(), 1e-300) if want.is_floating_point() else 1
            assert (mine[key] - want).abs().max().item() <= 1e-9 * scale, key
    np.testing.assert_allclose(runs[str(cuda), torch.float32][0],
                               runs["cpu", torch.float32][0], rtol=1e-4)


def test_first_gradients_on_the_card_match_cpu(cuda):
    from sed_tpu_torch.train.loss import weighted_bce_with_logits

    g = torch.Generator().manual_seed(1)
    x = torch.randn(16, 1, 30, 64, generator=g, dtype=torch.float64)
    y = (torch.rand(16, 30, 1, generator=g) > 0.7).double()
    grads = {}
    for dev in ("cpu", cuda):
        model = CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL,
                              generator=torch.Generator().manual_seed(0)).double().to(dev).train()
        weighted_bce_with_logits(model(x.to(dev)), y.to(dev)).backward()
        grads[str(dev)] = {k: p.grad.cpu() for k, p in model.named_parameters()}
    for key, want in grads["cpu"].items():
        err = (grads[str(cuda)][key] - want).abs().max().item()
        assert err <= 1e-9 * want.abs().max().item(), (key, err)


def test_train_mode_batch_norm_on_the_card(cuda):
    from sed_tpu_torch.models.layers import BatchNorm2d

    g = torch.Generator().manual_seed(2)
    xs = [torch.randn(8, 6, 5, 7, generator=g) * 2 + 0.5 for _ in range(4)]
    stats = []
    for dev in ("cpu", cuda):
        bn = BatchNorm2d(6).to(dev).train()
        for x in xs:
            bn(x.to(dev))
        stats.append((bn.running_mean.cpu(), bn.running_var.cpu()))
    # The flax rule in float64: 0.9 * old + 0.1 * the biased batch variance.
    mean, var = torch.zeros(6, dtype=torch.float64), torch.ones(6, dtype=torch.float64)
    for x in xs:
        v, m = torch.var_mean(x.double(), dim=(0, 2, 3), correction=0)
        mean, var = 0.9 * mean + 0.1 * m, 0.9 * var + 0.1 * v
    for got_mean, got_var in stats:
        assert (got_mean.double() - mean).abs().max() <= 1e-6
        assert (got_var.double() - var).abs().max() <= 1e-6


def test_train_mode_batch_norm_1d_on_the_card(cuda):
    """M5's BatchNorm1d: the flax rule over (batch, length) a channel."""
    from sed_tpu_torch.models.layers import BatchNorm1d

    g = torch.Generator().manual_seed(4)
    xs = [torch.randn(8, 6, 50, generator=g) * 2 + 0.5 for _ in range(4)]
    stats = []
    for dev in ("cpu", cuda):
        bn = BatchNorm1d(6).to(dev).train()
        for x in xs:
            bn(x.to(dev))
        stats.append((bn.running_mean.cpu(), bn.running_var.cpu()))
    mean, var = torch.zeros(6, dtype=torch.float64), torch.ones(6, dtype=torch.float64)
    for x in xs:
        v, m = torch.var_mean(x.double(), dim=(0, 2), correction=0)
        mean, var = 0.9 * mean + 0.1 * m, 0.9 * var + 0.1 * v
    for got_mean, got_var in stats:
        assert (got_mean.double() - mean).abs().max() <= 1e-6
        assert (got_var.double() - var).abs().max() <= 1e-6


class _WaveStore:
    """A packed waveform training split like WaveformDataset's."""

    def __init__(self, cfg, seed=0):
        rng = np.random.default_rng(seed)
        samples = 4 * cfg.frame_size
        self.long_waveform = (0.1 * rng.standard_normal((1, samples))).astype(np.float32)
        self.all_start_indices_labels = rng.random(samples) > 0.8
        self.possible_start_indices = rng.permutation(samples - cfg.frame_size).astype(np.int32)


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augment"])
def test_waveform_train_step_on_the_card_matches_cpu(cuda, augment):
    """M5 steps from one state, card against CPU: float64 within 1e-9
    (losses relative, gradients and state of each tensor's largest); the
    first float32 loss within 1e-4.  With augmentation, both apply the
    card's draws (the same generator state on both is not possible).  The
    conv biases are frozen: each feeds a BatchNorm, which removes it, so its
    gradient is zero up to rounding (~1e-15 in float64), which Adam would
    turn into steps that differ between the two and reach the running
    means."""
    import dataclasses

    from sed_tpu_torch.data import device_pipeline as pipe
    from sed_tpu_torch.train.state import init_state, make_train_step

    wcfg = WaveformConfig(working_sample_rate=8000)
    store = _WaveStore(wcfg)
    starts = store.possible_start_indices[:16]
    gather = pipe.make_waveform_gather(wcfg)
    card_bufs = pipe.waveform_buffers_from_dataset(store, cuda)
    draws = pipe.draw_augmentation(torch.Generator(device=cuda).manual_seed(1), card_bufs,
                                   (len(starts), 1, wcfg.frame_size), False)
    step = pipe.make_waveform_train_step(wcfg, 5.0, augment=False)
    ready_step = make_train_step(5.0, multi_frame=False)
    base = M5(1, generator=torch.Generator().manual_seed(0))

    def run_step(state, bufs, dev, dtype):
        if not augment:
            return step(state, bufs, starts)
        d = pipe.AugmentDraws(draws.u_mix.to(dev), draws.ptr.to(dev), draws.u_noise.to(dev),
                              draws.noise.to(dev, dtype))
        x, y = gather(bufs, torch.as_tensor(starts, device=dev))
        return ready_step(state, *pipe.apply_augmentation(bufs, x, y, d, gather, False,
                                                          pipe.WAVE_MIX_CUM))

    for name, p in base.named_parameters():
        if name.endswith((".0.bias", ".3.bias")):
            p.requires_grad_(False)
    runs = {}
    for dev in ("cpu", cuda):
        for dtype in (torch.float64, torch.float32):
            state = init_state(copy.deepcopy(base).to(dtype), 1e-3, dev)
            bufs = pipe.waveform_buffers_from_dataset(store, dev)
            bufs = dataclasses.replace(bufs, waveform=bufs.waveform.to(dtype),
                                       labels=bufs.labels.to(dtype))
            losses, grads = [], None
            for i in range(3 if dtype == torch.float64 else 1):
                losses.append(float(run_step(state, bufs, dev, dtype)))
                if i == 0:
                    grads = {k: p.grad.cpu() for k, p in state.model.named_parameters()
                             if p.requires_grad}
            runs[str(dev), dtype] = (losses, grads, {k: v.detach().cpu() for k, v in
                                                     state.model.state_dict().items()})
    cpu, gpu = runs["cpu", torch.float64], runs[str(cuda), torch.float64]
    np.testing.assert_allclose(gpu[0], cpu[0], rtol=1e-9)
    assert len(cpu[1]) == 29   # 9 conv and 1 dense weights, 9 BatchNorm pairs, fc's bias
    for mine, theirs in ((gpu[1], cpu[1]), (gpu[2], cpu[2])):
        for key, want in theirs.items():
            scale = max(want.abs().max().item(), 1e-300) if want.is_floating_point() else 1
            assert (mine[key] - want).abs().max().item() <= 1e-9 * scale, key
    np.testing.assert_allclose(runs[str(cuda), torch.float32][0],
                               runs["cpu", torch.float32][0], rtol=1e-4)


def test_multi_step_on_the_card_equals_single_steps(cuda):
    """K = 4 steps in one call against 4 single calls, one generator seed,
    cuDNN deterministic: equal losses and weights."""
    from sed_tpu_torch.data import device_pipeline as pipe
    from sed_tpu_torch.train.state import init_state

    wcfg = WaveformConfig(working_sample_rate=8000)
    store = _WaveStore(wcfg)
    bufs = pipe.waveform_buffers_from_dataset(store, cuda)
    step = pipe.make_waveform_train_step(wcfg, 5.0, augment=True)
    block = np.stack([store.possible_start_indices[8 * i:8 * i + 8] for i in range(4)])
    base = M5(1, generator=torch.Generator().manual_seed(0))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        single = init_state(copy.deepcopy(base), 1e-3, cuda)
        gen = torch.Generator(device=cuda).manual_seed(2)
        want = torch.stack([step(single, bufs, s, gen) for s in block])
        multi = init_state(copy.deepcopy(base), 1e-3, cuda)
        gen = torch.Generator(device=cuda).manual_seed(2)
        got = pipe.make_multi_step(step, 4)(multi, bufs, block, gen)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert torch.equal(got, want)
    for (k, v), w in zip(single.model.state_dict().items(), multi.model.state_dict().values()):
        assert torch.equal(v, w), k


def test_checkpoint_written_on_the_card_loads_on_the_cpu(cuda, tmp_path):
    from sed_tpu_torch.data import device_pipeline as pipe
    from sed_tpu_torch.train import checkpoint
    from sed_tpu_torch.train.state import init_state

    store = _TrainStore(False, SMALL)
    state = init_state(CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL), 1e-3, cuda, seed=0)
    bufs = pipe.spectrogram_buffers_from_dataset(store, cuda)
    step = pipe.make_spectrogram_train_step(SMALL, augment=False)
    for _ in range(2):
        step(state, bufs, store.train_start_indices[:8])
    path = checkpoint.save_checkpoint(state, str(tmp_path), 2)
    cpu_state = checkpoint.load_checkpoint(
        path, init_state(CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL), 1e-3, "cpu", seed=5))
    assert cpu_state.step == 2
    for key, value in state.model.state_dict().items():
        assert torch.equal(value.cpu(), cpu_state.model.state_dict()[key]), key
    p = next(cpu_state.model.parameters())
    assert cpu_state.optimizer.state[p]["exp_avg"].device.type == "cpu"
    model = cli.load_model(path, 1, "CnnAvgPooling")
    assert torch.equal(model.event_fc.weight, cpu_state.model.event_fc.weight)


def test_augmentation_draws_on_the_card(cuda):
    from sed_tpu_torch.data import device_pipeline as pipe

    store = _TrainStore(True, SMALL)
    bufs = pipe.spectrogram_buffers_from_dataset(store, cuda)
    gather = pipe.make_gather_crops(SMALL)
    f, e = gather(bufs, torch.as_tensor(store.train_start_indices[:8], device=cuda))
    aug = pipe.make_augment_batch(SMALL, "Complex")
    a = aug(torch.Generator(device=cuda).manual_seed(3), bufs, f, e)
    b = aug(torch.Generator(device=cuda).manual_seed(3), bufs, f, e)
    assert torch.equal(a[0], b[0]) and a[0].is_cuda
    # The same draws applied on the CPU give the same crops.
    d = pipe.draw_augmentation(torch.Generator(device=cuda).manual_seed(3), bufs, f.shape, True)
    cpu_d = pipe.AugmentDraws(d.u_mix.cpu(), d.ptr.cpu(), d.u_noise.cpu(), d.noise.cpu())
    cpu_bufs = pipe.spectrogram_buffers_from_dataset(store, "cpu")
    cf, ce = pipe.apply_augmentation(cpu_bufs, f.cpu(), e.cpu(), cpu_d, gather, True)
    assert (cf - a[0].cpu()).abs().max() <= 1e-6 and torch.equal(ce, a[1].cpu())


def test_batch_evaluator_launches_k1_and_k2_once(cuda):
    from sed_tpu_torch.inference import make_batch_evaluator

    model = CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL, generator=torch.Generator().manual_seed(0))
    waves = signals(2, 11 * PROD.working_sample_rate, PROD.working_sample_rate, cuda)
    targets = torch.zeros(2, 32, 1, device=cuda)
    evaluate = make_batch_evaluator(model, PROD, device=cuda)
    kernels.reset_launch_counts()
    scores, losses, recalls, precisions, aps = evaluate(waves[..., None], targets)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["wave_stft_power"] == 1 and kernels.LAUNCHES["mel_log"] == 1
    cpu = make_batch_evaluator(copy.deepcopy(model), PROD, device="cpu")(
        waves[..., None].cpu(), targets.cpu())
    assert (scores.cpu() - cpu[0]).abs().max() <= 1e-4
    assert recalls.shape == (2, 21) and aps.shape == (2,)


# ---- slice E, MobileNetV1 and M5 serving; sed_tpu's checkpoints --------------


def test_load_model_and_state_of_a_sed_tpu_checkpoint_scores_on_the_card(cuda, tmp_path):
    """A msgpack .ckpt in sed_tpu's layout loads through the port's reader
    onto the card and scores as the original weights on the CPU."""
    model = seeded_model("M5", 5)
    params, stats = torch_flax_ckpt.flax_trees("M5", model.state_dict())
    path = tmp_path / "iteration_9.ckpt"
    path.write_bytes(torch_flax_ckpt.msgpack({
        "step": 9, "params": params, "batch_stats": stats,
        "opt_state": {"0": {"count": np.zeros((), np.int32)}}}))
    loaded, state = cli.load_model_and_state(str(path), WaveformConfig(), arch="M5")
    assert next(loaded.parameters()).device.type == "cuda" and state.step == 0
    frames = signals(6, 31680, 48000, torch.device("cpu"), seed=3)[:, None]
    with torch.no_grad(), full_float32():
        got = loaded.eval()(frames.to(cuda)).cpu()
        want = model(frames)
    assert float((got - want).abs().max()) <= 1e-4


def test_m5_device_pool_on_the_card_matches_cpu(cuda):
    """DeviceWaveformStreamPool on the card against the same pool on the CPU:
    int16 and µ-law streams, uneven feeds, a backlog of more than
    ROUNDS_PER_CALL chunks, leave_many; no featurizer kernel launches."""
    from sed_tpu_torch.waveform_streaming import DeviceWaveformStreamPool

    model = seeded_model("M5", 6)
    rng = np.random.default_rng(6)
    clips = [(3000 * rng.standard_normal(n)).astype(np.int16)
             for n in (20 * 48000 + 777, 7 * 48000, 9 * 48000 + 5)]
    clips[2] = mulaw_encode(clips[2])
    out = {}
    kernels.reset_launch_counts()
    for dev in ("cpu", cuda):
        pool = DeviceWaveformStreamPool(copy.deepcopy(model), WaveformConfig(), slots=4,
                                        device=dev)
        slots = [pool.join() for _ in clips]
        acc = {s: [] for s in slots}
        pool.feed(slots[0], clips[0])          # the backlog: 20 chunks at once
        for pos in range(0, 9 * 48000 + 5, 30000):
            for s, y in zip(slots[1:], clips[1:]):
                pool.feed(s, y[pos:pos + 30000])
            for s, sc in pool.tick().items():
                acc[s].append(sc)
        for s, tail in pool.leave_many(slots).items():
            acc[s].append(tail)
        out[str(dev)] = [np.concatenate(acc[s]) for s in slots]
    assert sum(kernels.LAUNCHES.values()) == 0
    for a, b in zip(out["cpu"], out[str(cuda)]):
        assert a.shape == b.shape and a.shape[0] > 0
        assert float(np.abs(a - b).max()) <= 1e-4


def test_mobilenet_pool_launches_k3_and_k2_on_every_tick(cuda):
    """MobileNetV1's logits view in a StreamPool: one K3 and one K2 per
    featurize call (startup frames, each tick, the drain), none with
    featurizer='xla', whose scores match within 1e-4."""
    model = seeded_model("MobileNetV1", 7)
    logits = MobileNetV1(1, emit="logits")
    logits.load_state_dict(model.state_dict())
    rng = np.random.default_rng(7)
    audio = (3000 * rng.standard_normal((2, 8 * 48000))).astype(np.int16)
    got = {}
    for feat in ("auto", "xla"):
        pool = StreamPool(copy.deepcopy(logits), PROD, slots=2, halo=88, featurizer=feat,
                          device=cuda)
        slots = [pool.join(), pool.join()]
        kernels.reset_launch_counts()
        blocks = {s: [] for s in slots}
        for k in range(8):
            for s, sc in pool.push({s: audio[s, k * 48000:(k + 1) * 48000]
                                    for s in slots}).items():
                blocks[s].append(sc)
        for s, tail in pool.leave_many(slots).items():
            blocks[s].append(tail)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        if feat == "auto":
            assert launches["frames_stft_power"] >= 8 and launches["mel_log"] >= 8
            assert launches["frames_stft_power"] == launches["mel_log"]
        else:
            assert sum(launches.values()) == 0
        got[feat] = [np.concatenate(blocks[s]) for s in slots]
    want = make_batch_predictor(model, PROD, device="cpu")(audio[..., None]).numpy()
    for s in range(2):
        assert got["auto"][s].shape == got["xla"][s].shape == want[s].shape
        assert float(np.abs(got["auto"][s] - want[s]).max()) <= 1e-4
        assert float(np.abs(got["xla"][s] - want[s]).max()) <= 1e-4


# -- int8 serving: ops/int8.py and models/quantize.py -------------------------

INT8_SHAPES = [(m, k, n) for m in (1, 16, 300) for k in (9, 79, 192, 288, 1152)
               for n in (1, 11, 64)]


def int8_tensor(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)


@pytest.mark.parametrize("m,k,n", INT8_SHAPES)
def test_int8_matmul_on_the_card_is_exact(cuda, m, k, n):
    """``torch._int_mm`` on operands padded to its shape rules (rows > 16, K
    and N multiples of 8): one launch, equal to the plain version."""
    from sed_tpu_torch.ops import int8

    a, b = int8_tensor((m, k), m * k + n), int8_tensor((k, n), m + k * n)
    before = int8.LAUNCHES["int_mm"]
    got = int8.int8_matmul(a.to(cuda), b.to(cuda))
    torch.cuda.synchronize()
    assert int8.LAUNCHES["int_mm"] == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got.cpu(), int8.int8_matmul_plain(a, b))


@pytest.mark.parametrize("conv", ["2d-3x3-cin1", "2d-3x3", "2d-1x1", "1d-stem", "1d-3"])
def test_int8_convs_on_the_card_are_exact(cuda, conv):
    from sed_tpu_torch.ops import int8

    kind, shape = {"2d-3x3-cin1": ("2d", (1, 32, 3, 1)), "2d-3x3": ("2d", (32, 64, 3, 1)),
                   "2d-1x1": ("2d", (64, 11, 1, 0)), "1d-stem": ("1d", (1, 64, 79, 4, 39)),
                   "1d-3": ("1d", (64, 128, 3, 1, 1))}[conv]
    before = int8.LAUNCHES["int_mm"]
    if kind == "2d":
        cin, cout, k, pad = shape
        x, w = int8_tensor((3, 30, 64, cin), 1), int8_tensor((cout, cin, k, k), 2)
        run = lambda x, w: int8.int8_conv2d_nhwc(x, w, pad)  # noqa: E731
    else:
        cin, cout, k, stride, pad = shape
        x, w = int8_tensor((3, 2003, cin), 3), int8_tensor((cout, cin, k), 4)
        run = lambda x, w: int8.int8_conv1d_nwc(x, w, stride, pad)  # noqa: E731
    got = run(x.to(cuda), w.to(cuda))
    torch.cuda.synchronize()
    assert int8.LAUNCHES["int_mm"] == before + 1
    assert torch.equal(got.cpu(), run(x, w))


@pytest.mark.parametrize("arch", ["CnnAvgPooling", "MobileNetV1", "M5"])
def test_int8_forward_on_the_card_matches_cpu(cuda, arch):
    """One artifact (calibrated on the CPU), scored on the card and on the
    CPU: within 5e-3; the card's forward reaches ``_int_mm``."""
    from sed_tpu_torch.models import quantize as q
    from sed_tpu_torch.ops import int8

    model = cli.build_model(arch, 1)
    model.reset_parameters(torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(6)
    if arch == "M5":
        x = 0.1 * torch.randn(8, 1, WaveformConfig().frame_size, generator=g)
        qp = q.quantize_model(model, [x])[0]
        forward = lambda p, v: torch.sigmoid(q.quantized_m5_forward(p, v))  # noqa: E731
    else:
        x = torch.randn(4, 1, 182, 64, generator=g)
        qp = q.quantize_model(model, [x])[0]
        forward = q.quantized_serving_scores
    want = forward(qp, x)
    before = int8.LAUNCHES["int_mm"]
    got = forward(q.qparams_to(qp, cuda), x.to(cuda))
    torch.cuda.synchronize()
    assert int8.LAUNCHES["int_mm"] > before
    assert got.shape == want.shape
    assert float((got.cpu() - want).abs().max()) <= 5e-3


# ---------------------------------------------------------------------------
# AOT serving artifacts (sed_tpu_torch.export): K1 and K2 as custom operators
# ---------------------------------------------------------------------------

def pcm_clips(n, seconds, cuda, seed=0, sr=48000):
    return (signals(n, seconds * sr, sr, cuda, seed).clamp(-1, 1) * 32767) \
        .round().to(torch.int16)[..., None]


@pytest.mark.parametrize("name", ["wave_stft_power", "mel_log"])
def test_custom_ops_pass_opcheck_on_the_card(cuda, name):
    waves = signals(2, 5 * 8000, 8000, cuda)
    window = kernels.stft_window(SMALL, cuda)
    if name == "wave_stft_power":
        op, args = torch.ops.sed_tpu_torch.wave_stft_power, (waves, window, SMALL.hop_size,
                                                             SMALL.nfft)
    else:
        bands = kernels.mel_bands(SMALL, cuda)
        power = kernels.wave_stft_power(waves, window, SMALL.hop_size, SMALL.nfft)
        op, args = torch.ops.sed_tpu_torch.mel_log, (
            power.reshape(-1, SMALL.freq_bins), bands.segments, bands.band_first, bands.work,
            bands.weights, bands.dense, *bands.span)
    result = torch.library.opcheck(op, args)
    assert all(v == "SUCCESS" for v in result.values()), result


def test_exported_pipeline_equals_the_eager_predictor_on_the_card(cuda):
    """The CUDA artifact's scores equal ``make_batch_predictor``'s bit for
    bit, and each call launches K1 and K2 once; it refuses the CPU."""
    from sed_tpu_torch import export as ex

    model = seeded_model("CnnAvgPooling", 3).to(cuda)
    pcm = pcm_clips(2, 11, cuda, seed=4)
    with torch.inference_mode():
        feats = featurizer.logmel_features_batch(pcm, PROD)
    mean, std = feats.mean(dim=(0, 1, 2)).cpu().numpy(), feats.std(dim=(0, 1, 2)).cpu().numpy()
    blob = ex.aot_export_pipeline(ex.cnn_serving(model, mean, std), 2, pcm.shape[1], PROD,
                                  device=cuda)
    call = ex.load_aot_fn(blob)
    assert call.header["custom_ops"] == ["mel_log", "wave_stft_power"]
    # ``cuda`` has no index: the featurizer's tables must still be constants
    # of the program, not host tables copied to the card on every call.
    assert "lift_fresh_copy" not in call.module.code
    assert call.header["kernel_library"]["digest"] == kernels.library_digest()
    want = make_batch_predictor(model, PROD, mean=mean, std=std, device=cuda)(pcm)
    kernels.reset_launch_counts()
    got = call(pcm)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["wave_stft_power"] == 1 and kernels.LAUNCHES["mel_log"] == 1
    assert torch.equal(got, want)
    np.testing.assert_array_equal(ex.load_aot_pipeline(blob)(pcm.cpu().numpy()),
                                  want.cpu().numpy())
    with pytest.raises(ValueError, match="traced on cuda and runs only there"):
        ex.load_aot_pipeline(blob, device="cpu")


@pytest.mark.parametrize("arch", ["CnnAvgPooling", "MobileNetV1", "M5"])
def test_exported_int8_and_bf16_heads_equal_their_eager_forwards(cuda, arch):
    """int8 (``torch._int_mm`` in the graph) and bf16 artifacts on the card
    against their heads called eagerly: equal."""
    from sed_tpu_torch import export as ex
    from sed_tpu_torch.models import quantize as q

    model = seeded_model(arch, 6).to(cuda)
    if arch == "M5":
        cfg = WaveformConfig()
        pcm = pcm_clips(2, 4, cuda, seed=7)
        frames = cli.hop_frames(pcm[0].float() / 32768.0, cfg)
        heads = {"int8": ex.m5_quantized_serving(q.quantize_m5(model, [frames])),
                 "bf16": ex.m5_serving(M5(1, dtype=torch.bfloat16).to(cuda))}
        heads["bf16"].model.load_state_dict(model.state_dict())
        export = lambda h: ex.aot_export_m5_pipeline(h, 2, pcm.shape[1], cfg,  # noqa: E731
                                                     device=cuda)
        n = (pcm.shape[1] - 2 * (cfg.frame_size // 2)) // cfg.hop_size + 1
        windows = pcm[..., 0].float().div(32768.0).unfold(1, 2 * (cfg.frame_size // 2),
                                                          cfg.hop_size)[:, :n]
        eager = lambda h: h(windows.reshape(-1, 1, windows.shape[-1])).reshape(2, n, -1)  # noqa: E731
    else:
        pcm = pcm_clips(2, 11, cuda, seed=7)
        with torch.inference_mode():
            feats = featurizer.logmel_features_batch(pcm, PROD)
        if arch == "MobileNetV1":
            model.emit = "logits"
            int8_head = ex.mobilenet_quantized_serving(q.quantize_mobilenet(model, [feats]))
            bf16 = MobileNetV1(1, emit="logits", dtype=torch.bfloat16)
        else:
            int8_head = ex.quantized_serving(q.quantize_cnn(model, [feats]))
            bf16 = CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL, dtype=torch.bfloat16)
        bf16.load_state_dict(model.state_dict())
        heads = {"int8": int8_head, "bf16": ex.cnn_serving(bf16.to(cuda))}
        export = lambda h: ex.aot_export_pipeline(h, 2, pcm.shape[1], PROD,  # noqa: E731
                                                  device=cuda)
        eager = lambda h: h(feats)  # noqa: E731
    for tier, head in heads.items():
        call = ex.load_aot_fn(export(head))
        with torch.inference_mode(), full_float32():
            want = eager(head.eval())
        got = call(pcm)
        assert got.dtype == torch.float32
        assert torch.equal(got, want), (tier, float((got - want).abs().max()))


def test_library_installed_from_an_artifact_loads_and_launches(cuda, tmp_path):
    """A fresh process on a copy of the package with an empty ``_build/``
    and an ``nvcc`` that only records being called: the artifact installs
    its library, the program launches K1 and K2 from it, and nvcc never
    runs."""
    import json
    import os
    import shutil
    import subprocess
    import sys
    from pathlib import Path

    from sed_tpu_torch import export as ex

    model = seeded_model("CnnAvgPooling", 8).to(cuda)
    pcm = pcm_clips(2, 11, cuda, seed=9)
    blob = ex.aot_export_pipeline(ex.cnn_serving(model), 2, pcm.shape[1], PROD, device=cuda)
    (tmp_path / "a.aot").write_bytes(blob)
    np.save(tmp_path / "pcm.npy", pcm.cpu().numpy())
    want = ex.load_aot_pipeline(blob)(pcm.cpu().numpy())
    package = Path(kernels.__file__).resolve().parents[1]
    shutil.copytree(package, tmp_path / "copy" / "sed_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    fake = tmp_path / "cuda_home" / "bin"
    fake.mkdir(parents=True)
    (fake / "nvcc").write_text(f"#!/bin/sh\ntouch {tmp_path / 'nvcc_ran'}\nexit 1\n")
    (fake / "nvcc").chmod(0o755)
    script = (
        "import json, sys, numpy as np\n"
        "from sed_tpu_torch import export as ex\n"
        "from sed_tpu_torch.ops import cuda_featurizer as k\n"
        f"call = ex.load_aot_pipeline(open({str(tmp_path / 'a.aot')!r}, 'rb').read())\n"
        f"np.save({str(tmp_path / 'got.npy')!r}, call(np.load({str(tmp_path / 'pcm.npy')!r})))\n"
        "print(json.dumps({'launches': k.LAUNCHES, 'library': str(k.library_path()),\n"
        "                  'exists': k.library_path().exists()}))\n")
    env = dict(os.environ, PYTHONPATH=str(tmp_path / "copy"),
               CUDA_HOME=str(tmp_path / "cuda_home"))
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path / "copy", env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["exists"] and out["library"].startswith(str(tmp_path / "copy"))
    assert out["launches"]["wave_stft_power"] == 1 and out["launches"]["mel_log"] == 1
    assert not (tmp_path / "nvcc_ran").exists()
    np.testing.assert_array_equal(np.load(tmp_path / "got.npy"), want)


# -- the bf16 tier on the live paths; the native reader -------------------------

@pytest.mark.parametrize("arch", ["CnnAvgPooling", "MobileNetV1"])
def test_bf16_tick_on_the_card_follows_float32(cuda, arch):
    """A StreamPool whose model computes in bfloat16 (the stream CLI's
    ``--bf16``) on the card: K3 and K2 on every tick as in float32, the ring
    state float32, and every stream's scores within sed_tpu's 0.05 band of
    the float32 pool's (not equal: the CNN does run in bfloat16)."""
    model = seeded_model(arch, 10)
    rng = np.random.default_rng(10)
    audio = (3000 * rng.standard_normal((3, 9 * 48000 + 321))).astype(np.int16)
    halo = 88 if arch == "MobileNetV1" else 64
    got, launches = {}, {}
    for tier, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        if arch == "MobileNetV1":
            m = MobileNetV1(1, emit="logits", dtype=dtype)
        else:
            m = CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL, dtype=dtype)
        m.load_state_dict(model.state_dict())
        pool = StreamPool(m, PROD, slots=3, halo=halo, device=cuda)
        slots = [pool.join() for _ in range(3)]
        blocks = {s: [] for s in slots}
        kernels.reset_launch_counts()
        for pos in range(0, audio.shape[1], 30000):
            for s in slots:
                pool.feed(s, audio[s, pos:pos + 30000])
            for s, sc in pool.tick().items():
                blocks[s].append(sc)
        for s, tail in pool.leave_many(slots).items():
            blocks[s].append(tail)
        torch.cuda.synchronize()
        launches[tier] = dict(kernels.LAUNCHES)
        got[tier] = [np.concatenate(blocks[s]) for s in slots]
    assert launches["bf16"] == launches["f32"] and launches["bf16"]["frames_stft_power"] >= 9
    assert launches["bf16"]["frames_stft_power"] == launches["bf16"]["mel_log"]
    dev = 0.0
    for a, b in zip(got["bf16"], got["f32"]):
        assert a.shape == b.shape and a.shape[0] > 0 and a.dtype == np.float32
        dev = max(dev, float(np.abs(a - b).max()))
    assert 0.0 < dev <= 0.05, dev


def test_native_reader_in_a_cuda_process(cuda, tmp_path):
    """The native reader (built with g++ at first use) in a process that
    holds a CUDA context: ``read_wav`` equal to the scipy plain version on
    int16 PCM, the batch loader on four threads equal to the sequential
    path, and ``preprocess_data(workers=2)`` on the card writing the
    pickles of ``workers=0``."""
    import os
    import pickle

    from sed_tpu_torch.data.preprocess import preprocess_data
    from sed_tpu_torch.io import audio, native

    torch.zeros(1, device=cuda)
    rng = np.random.default_rng(12)
    paths = []
    for i in range(5):
        paths.append(str(tmp_path / f"c{i}.wav"))
        wavfile.write(paths[-1], 48000, (3000 * rng.standard_normal(3 * 48000 + 77 * i))
                      .astype(np.int16))
    assert native.native_available() and native.build().path.exists()
    got, sr = audio.read_wav(paths[0])
    want, _ = audio.read_wav_plain(paths[0])
    assert sr == 48000
    np.testing.assert_array_equal(got, want)
    par = audio.read_multichannel_audio_batch(paths, 48000, workers=4)
    seq = audio.read_multichannel_audio_batch(paths, 48000, workers=0)
    for a, b in zip(par, seq):
        np.testing.assert_array_equal(a, b)
    items = [(p, np.array([0.5]), np.array([1.0]), f"c{i}") for i, p in enumerate(paths)]
    for w in (0, 2):
        preprocess_data(items, str(tmp_path / f"f{w}"), str(tmp_path / f"m{w}.pkl"),
                        workers=w, device=cuda, plot_sample=False)
    for name in sorted(os.listdir(tmp_path / "f0")):
        with open(tmp_path / "f0" / name, "rb") as fa, open(tmp_path / "f2" / name, "rb") as fb:
            np.testing.assert_array_equal(pickle.load(fa)["features"],
                                          pickle.load(fb)["features"])


# ---- slice G part 1: a one-rank NCCL mesh ----------------------------------------


@pytest.fixture
def nccl_mesh(cuda):
    """``create_mesh(1)``: a one-rank NCCL group on the card, torn down after."""
    from sed_tpu_torch.parallel.mesh import create_mesh
    from sed_tpu_torch.parallel.multihost import shutdown_multihost

    mesh = create_mesh(1)
    try:
        yield mesh
    finally:
        shutdown_multihost()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_mesh_train_step_on_the_card_matches_the_plain_step(nccl_mesh, dtype):
    """One CnnAvgPooling step with augmentation, the mesh's (NCCL all-reduces,
    the global BatchNorm) against the plain one (cuDNN's BatchNorm) from one
    state and one generator seed: the loss within rtol 1e-5, the BatchNorm
    statistics within rtol 1e-5 / atol 1e-6, parameters within 1e-5 (at lr
    1e-6 in float32, where the two BatchNorm backwards' float32 sums may
    flip the sign of a near-zero gradient, which Adam's first step turns
    into a move of lr), and the gradients the update applied: within rtol
    1e-3 / atol 5e-6 in float64 (tests/test_parallel.py:214-215), and in
    float32 within 2e-2 of each tensor's largest (the mesh's float32
    gradients part from cuDNN's by 2.8e-3 to 6.6e-3 of it, PERF.md)."""
    from sed_tpu_torch.data import device_pipeline as pipe
    from sed_tpu_torch.parallel.data_parallel import shard_train_step
    from sed_tpu_torch.train.state import init_state

    rng = np.random.default_rng(3)
    total = 40 * PROD.train_crop_size
    bufs = pipe.SpectrogramBuffers(
        features=torch.from_numpy(rng.standard_normal((1, total, 64))).to(nccl_mesh.device,
                                                                           dtype),
        events=torch.from_numpy((rng.random((total, 1)) > 0.8).astype(np.float32)).to(
            nccl_mesh.device),
        start_indices=torch.arange(total - PROD.train_crop_size, device=nccl_mesh.device),
        mean=torch.zeros(64, device=nccl_mesh.device, dtype=dtype),
        std=torch.ones(64, device=nccl_mesh.device, dtype=dtype))
    starts = rng.integers(0, total - PROD.train_crop_size, size=32)
    raw = pipe.make_spectrogram_train_step(PROD, 5.0, "logMel", True)
    lr = 1e-3 if dtype == torch.float64 else 1e-6
    out = []
    for step in (raw, shard_train_step(raw, nccl_mesh)):
        model = CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL,
                              generator=torch.Generator().manual_seed(0)).to(dtype)
        state = init_state(model, lr, nccl_mesh.device)
        loss = step(state, bufs, starts, torch.Generator(device=nccl_mesh.device).manual_seed(4))
        out.append((float(loss), {k: v.cpu() for k, v in state.model.state_dict().items()},
                    {k: p.grad.cpu() for k, p in state.model.named_parameters()}))
    (loss1, sd1, g1), (loss2, sd2, g2) = out
    assert abs(loss2 - loss1) <= 1e-5 * abs(loss1)
    for key, want in g1.items():
        if dtype == torch.float64:
            torch.testing.assert_close(g2[key], want, rtol=1e-3, atol=5e-6, msg=key)
        else:
            assert (g2[key] - want).abs().max() <= 2e-2 * want.abs().max(), key
    for key, want in sd1.items():
        if key.endswith("num_batches_tracked"):
            assert torch.equal(sd2[key], want)
        elif "running_" in key:
            torch.testing.assert_close(sd2[key], want, rtol=1e-5, atol=1e-6, msg=key)
        else:
            assert (sd2[key] - want).abs().max() <= 1e-5, key


def test_mesh_predictor_on_the_card_launches_k1_and_k2_once(nccl_mesh):
    """``make_batch_predictor(mesh=)`` at world size 1: one K1 and one K2
    launch a call, scores within 1e-6 of the plain predictor."""
    model = CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL, generator=torch.Generator().manual_seed(0))
    waves = (signals(4, 11 * PROD.working_sample_rate, PROD.working_sample_rate, nccl_mesh.device)
             * 32767).round().to(torch.int16)[..., None]
    plain = make_batch_predictor(model, PROD, device=nccl_mesh.device)(waves)
    predict = make_batch_predictor(model, PROD, mesh=nccl_mesh)
    kernels.reset_launch_counts()
    got = predict(waves)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["wave_stft_power"] == 1 and kernels.LAUNCHES["mel_log"] == 1
    assert got.shape == plain.shape
    assert (got - plain).abs().max() <= 1e-6


# ---- the SVM baseline (sed_tpu_torch.classical) ------------------------------------

SVM_CARD_TOL = 1e-3   # decision values and probabilities, card against CPU (the solver's tol)


def svm_problem(n=400, d=16, seed=0, rp=10.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d))
    y = (x[:, 0] + 0.5 * x[:, 1] ** 2 + 0.7 * rng.standard_normal(n) > 1.0).astype(float)
    return x, y, y * rp + (1 - y)


def test_svm_featurizer_on_the_card_matches_cpu(cuda):
    from sed_tpu_torch.classical.svm import featurize_frames

    wcfg = WaveformConfig()
    frames = np.random.default_rng(0).standard_normal((8, wcfg.frame_size))
    frames[0] *= 1e-4
    got = featurize_frames(frames, wcfg, device=cuda)
    want = featurize_frames(frames, wcfg, device="cpu")
    assert got.shape == want.shape == (8, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_svc_solver_on_the_card_matches_cpu(cuda):
    """The weighted soft SVC fitted on the card against the CPU fit of the
    same rows, and the CUDA-graph iterations equal to eager ones."""
    from sed_tpu_torch.classical import svc
    from sed_tpu_torch.classical.svm import SVMDetector

    x, y, w = svm_problem()
    card = SVMDetector(device=cuda).fit(x, y, w)
    host = SVMDetector(device="cpu").fit(x, y, w)
    np.testing.assert_allclose(card.decision_function(x), host.decision_function(x),
                               rtol=0, atol=SVM_CARD_TOL)
    np.testing.assert_allclose(card.predict(x), host.predict(x), rtol=0, atol=SVM_CARD_TOL)
    xd = torch.as_tensor(x, device=cuda)
    yd = torch.as_tensor(np.where(y == 0, 1.0, -1.0), device=cuda)
    cd = torch.as_tensor(w, device=cuda)
    graphed = svc.solve_dual(xd, yd, cd, svc.gamma_scale(x), graph=True)
    eager = svc.solve_dual(xd, yd, cd, svc.gamma_scale(x), graph=False)
    assert graphed.n_iter == eager.n_iter > 0 and graphed.rho == eager.rho
    assert torch.equal(graphed.alpha, eager.alpha)


# ---------------------------------------------------------------------------
# K1t and K3t (the bf16 tensor-core DFT of the reduced tiers), K2's bf16 modes
# ---------------------------------------------------------------------------

def tier_tol(precision) -> float:
    """Against the plain version (exact float64 sums of the same bf16
    products), x the frame's peak power: the tensor cores' f32 accumulation
    ~1e-5; where the outer stage is bf16x1, an ulp of difference in the
    twiddled T flips its one bf16 rounding (7.3e-5 at 16 x 60 s).
    Neighbouring modes are told apart by ``kernels.mode_fraction``, not by
    these limits."""
    return 1.5e-3 if kernels.tier_passes(precision)[1] == 1 else 3e-5


# The mode next to each precision the tests run, which the kernel's output
# must not lean towards: the lo.lo term, the inner stage's lo chunks, the x6
# terms; K2's bf16x3 next to its f32 product (None).
TIER_NEIGHBOUR = {"bf16x3": "bf16x4", "bf16x1": ("bf16x3", "bf16x1"),
                  ("bf16x6", "bf16x4"): "bf16x4", ("bf16x1", "bf16x3"): "bf16x3"}
MEL_NEIGHBOUR = {"bf16x1": "bf16x3", "bf16x3": None}
MODE_FRACTION_TOL = 0.5   # nearer its own mode than the next (chip_smoke.py's MODE_FRACTION_TOL)


def tier_cfg(n_fft: int) -> SpectrogramConfig:
    cfg = SpectrogramConfig(working_sample_rate=8000, time_margin=0.7 * n_fft / 16000)
    assert cfg.nfft == n_fft
    return cfg


@pytest.mark.parametrize("precision", ["bf16x3", "bf16x1", ("bf16x6", "bf16x4"),
                                       ("bf16x1", "bf16x3")], ids=str)
@pytest.mark.parametrize("n_fft", [2048, 4096, 8192, 16384, 32768])
def test_k1t_matches_its_plain_version(cuda, n_fft, precision):
    cfg = tier_cfg(n_fft) if n_fft != PROD.nfft else PROD
    waves = signals(3, 5 * cfg.working_sample_rate + 321, cfg.working_sample_rate, cuda)
    window = kernels.stft_window(cfg, cuda)
    before = kernels.LAUNCHES["wave_dft_power_bf16"]
    got = kernels.wave_dft_power_bf16(waves, window, cfg.hop_size, n_fft, precision)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["wave_dft_power_bf16"] == before + 1
    want = kernels.wave_dft_power_bf16_plain(waves, window, cfg.hop_size, n_fft, precision)
    assert got.shape == want.shape == (3, 1 + waves.shape[1] // cfg.hop_size, n_fft // 2 + 1)
    peak = want.amax(dim=-1, keepdim=True)
    rel = float(((got - want).abs() / peak.clamp_min(1e-30)).max())
    assert rel <= tier_tol(precision), rel
    # The mode, on broadband noise: on the tones above a few bins carry each
    # frame, too few to see the gap between the modes.
    g = torch.Generator(device=cuda).manual_seed(5)
    noise = 0.3 * torch.randn(waves.shape, generator=g, device=cuda)
    got = kernels.wave_dft_power_bf16(noise, window, cfg.hop_size, n_fft, precision)
    want, neighbour = (kernels.wave_dft_power_bf16_plain(noise, window, cfg.hop_size, n_fft, p)
                       for p in (precision, TIER_NEIGHBOUR[precision]))
    peak = want.amax(dim=-1, keepdim=True)
    t = kernels.mode_fraction(got, want, neighbour, peak)
    assert abs(t) <= MODE_FRACTION_TOL, t
    at_next = kernels.wave_dft_power_bf16(noise, window, cfg.hop_size, n_fft,
                                          TIER_NEIGHBOUR[precision])
    t_next = kernels.mode_fraction(at_next, want, neighbour, peak)
    assert t_next >= 1 - MODE_FRACTION_TOL, t_next


@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
@pytest.mark.parametrize("precision", ["bf16x3", "bf16x1"])
def test_k3t_matches_its_plain_version(cuda, precision, dtype):
    g = torch.Generator(device=cuda).manual_seed(3)
    rows = 0.3 * torch.randn(160, SMALL.nfft, generator=g, device=cuda)
    if dtype == torch.int16:
        rows = (rows * 8000).round().to(torch.int16)
    window = kernels.stft_window(SMALL, cuda)
    before = kernels.LAUNCHES["frames_dft_power_bf16"]
    got = kernels.frames_dft_power_bf16(rows, window, SMALL.nfft, precision)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["frames_dft_power_bf16"] == before + 1
    want = kernels.frames_dft_power_bf16_plain(rows, window, SMALL.nfft, precision)
    peak = want.amax(dim=-1, keepdim=True)
    rel = float(((got - want).abs() / peak).max())
    assert rel <= tier_tol(precision), rel
    neighbour = kernels.frames_dft_power_bf16_plain(rows, window, SMALL.nfft,
                                                    TIER_NEIGHBOUR[precision])
    t = kernels.mode_fraction(got, want, neighbour, peak)
    assert abs(t) <= MODE_FRACTION_TOL, t
    at_next = kernels.frames_dft_power_bf16(rows, window, SMALL.nfft, TIER_NEIGHBOUR[precision])
    t_next = kernels.mode_fraction(at_next, want, neighbour, peak)
    assert t_next >= 1 - MODE_FRACTION_TOL, t_next
    lm = featurizer.logmel_frames(rows, SMALL, precision)   # K3t then K2
    assert lm.shape == (160, SMALL.mel_bins) and bool(torch.isfinite(lm).all())


@pytest.mark.parametrize("rows", [100, 600])
@pytest.mark.parametrize("mel_precision", ["bf16x1", "bf16x3"])
def test_k2_bf16_modes_match_their_plain_versions(cuda, mel_precision, rows):
    """Both row paths of K2 (one row at a time below 4 x the SMs, four
    above) at each bf16 product mode: one launch, within 1.5e-5 dB of the
    plain version's exact products (phase 20 reads 7.5e-6 and 7.9e-6), and
    nearer them than the next mode's."""
    g = torch.Generator(device=cuda).manual_seed(4)
    power = torch.rand(rows, PROD.freq_bins, generator=g, device=cuda) ** 4 * 1e3
    bands = kernels.mel_bands(PROD, cuda)
    before = kernels.LAUNCHES["mel_log_bf16"]
    got = kernels.mel_log(power, bands, mel_precision)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mel_log_bf16"] == before + 1
    fb64 = torch.from_numpy(mel_ops.mel_filterbank(PROD, np.float64)).to(cuda)
    want = kernels.mel_log_plain(power.double(), fb64, mel_precision)
    err = float((got.double() - want).abs().max())
    assert err <= 1.5e-5, err
    neighbour = kernels.mel_log_plain(power.double(), fb64, MEL_NEIGHBOUR[mel_precision])
    t = kernels.mode_fraction(got, want, neighbour)
    assert abs(t) <= MODE_FRACTION_TOL, t
    at_next = kernels.mel_log(power, bands, MEL_NEIGHBOUR[mel_precision])
    t_next = kernels.mode_fraction(at_next, want, neighbour)
    assert t_next >= 1 - MODE_FRACTION_TOL, t_next


def test_tier_kernels_refuse_what_they_do_not_take(cuda):
    small = SpectrogramConfig(working_sample_rate=8000, time_margin=0.003)   # n_fft 64
    assert small.nfft == 64
    waves = signals(1, 8000, 8000, cuda)
    with pytest.raises(ValueError, match="128 to 1048576"):
        kernels.wave_dft_power_bf16(waves, kernels.stft_window(small, cuda), small.hop_size,
                                    small.nfft, "bf16x3")
    window = kernels.stft_window(SMALL, cuda)
    with pytest.raises(ValueError, match="featurizer precision"):
        kernels.wave_dft_power_bf16(waves, window, SMALL.hop_size, SMALL.nfft, "bf16x2")
    with pytest.raises(ValueError, match="parity tier"):
        kernels.frames_dft_power_bf16(torch.zeros(2, SMALL.nfft, device=cuda), window,
                                      SMALL.nfft, None)
    with pytest.raises(TypeError, match="float32 or int16"):
        kernels.frames_dft_power_bf16(torch.zeros(2, SMALL.nfft, device=cuda,
                                                  dtype=torch.float64), window, SMALL.nfft,
                                      "bf16x3")
    with pytest.raises(ValueError, match="contiguous"):
        kernels.frames_dft_power_bf16(torch.zeros(SMALL.nfft, 2, device=cuda).t(), window,
                                      SMALL.nfft, "bf16x3")
    small = tier_cfg(128)   # K6t transforms m = n_fft / 2 points: 128 is below it
    assert small.hop_size % 2 == 0
    with pytest.raises(ValueError, match="256 to 1048576"):
        kernels.wave_packed_fft_bf16(waves, kernels.stft_window(small, cuda), small.hop_size,
                                     small.nfft, "bf16x3")
    with pytest.raises(ValueError, match="256 to 1048576"):
        kernels.logmel_waveform(waves, small, impl="pack", precision="bf16x1")
    # K5t: 'fuse' at a tier starts at 2048, as sed_tpu's does.
    with pytest.raises(ValueError, match="2048 to 1048576"):
        kernels.wave_stft_mel_log_bf16(waves, kernels.stft_window(small, cuda), small.hop_size,
                                       small.nfft, kernels.mel_bands(small, cuda), "bf16x3")
    with pytest.raises(ValueError, match="exceeds 1048576"):
        kernels.wave_dft_power_bf16(waves, torch.zeros(1 << 21, device=cuda), 1000, 1 << 21,
                                    "bf16x3")


# ---------------------------------------------------------------------------
# K5t, K5b and K6t: 'fuse' and 'pack' at the reduced tiers
# ---------------------------------------------------------------------------

FUSE_MODES = [("bf16x3", None), ("bf16x1", None), ("bf16x4", None), ("bf16x6", None),
              (("bf16x1", "bf16x3"), None), ("bf16x3", "bf16x1"), ("bf16x1", "bf16x3"),
              (("bf16x6", "bf16x4"), "bf16x3")]


@pytest.mark.parametrize("precision, mel_precision", FUSE_MODES, ids=str)
@pytest.mark.parametrize("n_fft", [2048, 8192, 32768])
def test_k5t_equals_k1t_then_k2(cuda, n_fft, precision, mel_precision):
    """K5t is K1t's route then K2 at mel_precision's mode (the launch plan's
    kernels, once each): equal to K1t then K2 bit for bit, with 1, 2 and 4
    units a frame."""
    cfg = tier_cfg(n_fft) if n_fft != PROD.nfft else PROD
    waves = signals(3, 5 * cfg.working_sample_rate + 321, cfg.working_sample_rate, cuda)
    window, bands = kernels.stft_window(cfg, cuda), kernels.mel_bands(cfg, cuda)
    route = kernels.launch_plan(n_fft, passes=kernels.tier_passes(precision))
    mel = "mel_log_bf16" if kernels.mel_passes(mel_precision) else "mel_log"
    got = launched_once(lambda: kernels.wave_stft_mel_log_bf16(
        waves, window, cfg.hop_size, n_fft, bands, precision, mel_precision),
        *route["wave_stft_mel_log_bf16"]["kernels"][:-1], mel)
    power = kernels.wave_dft_power_bf16(waves, window, cfg.hop_size, n_fft, precision)
    two = kernels.mel_log(power.reshape(-1, n_fft // 2 + 1), bands, mel_precision)
    assert got.shape == (3, 1 + waves.shape[1] // cfg.hop_size, bands.n_mels)
    assert torch.equal(got.reshape(-1, bands.n_mels), two)


@pytest.mark.parametrize("mel_precision", ["bf16x1", "bf16x3"])
@pytest.mark.parametrize("n_fft", [256, 4096, 32768])
def test_k5b_equals_k1_then_k2b(cuda, n_fft, mel_precision):
    """K5 at K2's bf16 modes: equal to K1 then K2 at that mode bit for bit,
    with fewer than 32 threads (whole bands a thread) and with warps."""
    hop, win = 3 * n_fft // 8, n_fft - n_fft // 8
    waves = signals(3, 3 * n_fft + 11, 8000, cuda)
    window = torch.from_numpy(stft_ops.padded_window(win, n_fft).copy()).to(cuda)
    bands = bands_at(n_fft, cuda)
    before = kernels.LAUNCHES["wave_stft_mel_log_mel_bf16"]
    got = kernels.wave_stft_mel_log(waves, window, hop, n_fft, bands, mel_precision)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["wave_stft_mel_log_mel_bf16"] == before + 1
    power = kernels.wave_stft_power(waves, window, hop, n_fft)
    two = kernels.mel_log(power.reshape(-1, n_fft // 2 + 1), bands, mel_precision)
    assert torch.equal(got.reshape(-1, bands.n_mels), two)


@pytest.mark.parametrize("precision", ["bf16x3", "bf16x1", ("bf16x6", "bf16x4"),
                                       ("bf16x1", "bf16x3")], ids=str)
@pytest.mark.parametrize("n_fft", [4096, 8192, 16384, 32768, 65536, 131072])
def test_k6t_matches_its_plain_version(cuda, n_fft, precision):
    """K6t against its plain version within phase 20's tier_rel_tol x the
    frame's peak |Z|, and, on broadband noise, nearer its own mode than the
    next (kernels.mode_fraction)."""
    cfg = tier_cfg(n_fft) if n_fft != PROD.nfft else PROD
    waves = signals(3, 5 * cfg.working_sample_rate + 321, cfg.working_sample_rate, cuda)
    window = kernels.stft_window(cfg, cuda)
    before = kernels.LAUNCHES["wave_packed_fft_bf16"]
    zr, zi = kernels.wave_packed_fft_bf16(waves, window, cfg.hop_size, n_fft, precision)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["wave_packed_fft_bf16"] == before + 1
    wr, wi = kernels.wave_packed_fft_bf16_plain(waves, window, cfg.hop_size, n_fft, precision)
    assert zr.shape == zi.shape == wr.shape == (3, 1 + waves.shape[1] // cfg.hop_size,
                                                n_fft // 2)
    peak = torch.hypot(wr, wi).amax(dim=-1, keepdim=True)
    rel = max(float(((z - w).abs() / peak).max()) for z, w in ((zr, wr), (zi, wi)))
    assert rel <= tier_tol(precision), rel
    g = torch.Generator(device=cuda).manual_seed(6)
    noise = 0.3 * torch.randn(waves.shape, generator=g, device=cuda)

    def packed(fn, prec):
        return torch.cat(fn(noise, window, cfg.hop_size, n_fft, prec), dim=-1)

    want = packed(kernels.wave_packed_fft_bf16_plain, precision)
    neighbour = packed(kernels.wave_packed_fft_bf16_plain, TIER_NEIGHBOUR[precision])
    zr, zi = want.chunk(2, dim=-1)
    scale = torch.hypot(zr, zi).amax(dim=-1, keepdim=True)
    t = kernels.mode_fraction(packed(kernels.wave_packed_fft_bf16, precision), want, neighbour,
                              scale)
    assert abs(t) <= MODE_FRACTION_TOL, t
    t_next = kernels.mode_fraction(packed(kernels.wave_packed_fft_bf16,
                                          TIER_NEIGHBOUR[precision]), want, neighbour, scale)
    assert t_next >= 1 - MODE_FRACTION_TOL, t_next


@pytest.mark.parametrize("impl, precision, mel_precision", [
    ("fuse", "bf16x3", None), ("fuse", "bf16x1", "bf16x3"), ("fuse", None, "bf16x1"),
    ("pack", "bf16x3", None), ("pack", ("bf16x1", "bf16x3"), "bf16x1")], ids=str)
def test_fuse_and_pack_tiers_launch_their_row(cuda, impl, precision, mel_precision):
    """logmel_waveform at a tier or a mel mode launches exactly the kernels
    impl_kernels names (REDUCED_IMPL_KERNELS' row at a tier), once each; on
    broadband noise its log-mel is within the tier's class of float64
    (fast 1e-3 dB, a bf16x1 stage or mel 0.05 dB)."""
    g = torch.Generator(device=cuda).manual_seed(7)
    waves = (0.3 * torch.randn(2, 20 * 8000 + 1317, generator=g, device=cuda)).contiguous()
    kernels.reset_launch_counts()
    got = kernels.logmel_waveform(waves, SMALL, impl=impl, precision=precision,
                                  mel_precision=mel_precision)
    torch.cuda.synchronize()
    want_launches = dict.fromkeys(kernels.LAUNCHES, 0)
    want_launches.update(dict.fromkeys(kernels.impl_kernels(impl, precision, mel_precision,
                                                            n_fft=SMALL.nfft), 1))
    assert kernels.LAUNCHES == want_launches
    if precision is not None:
        assert kernels.impl_kernels(impl, precision) == kernels.REDUCED_IMPL_KERNELS[impl]
    window = kernels.stft_window(SMALL, cuda)
    fb64 = torch.from_numpy(mel_ops.mel_filterbank(SMALL, np.float64)).to(cuda)
    chain = kernels.wave_stft_mel_log_plain(waves.double(), window, SMALL.hop_size, SMALL.nfft,
                                            fb64)
    stages = precision if isinstance(precision, tuple) else (precision,)
    tol = 0.05 if "bf16x1" in stages + (mel_precision,) else 1e-3
    assert got.shape == chain.shape
    assert float((got.double() - chain).abs().max()) <= tol


# ---------------------------------------------------------------------------
# n_fft 65536 and 131072 (96 and 192 kHz): the cluster FFT (K1, K3, K5, K5b,
# K6), K2 at 32,769 and 65,537 bins, the tier kernels at n1 = 256
# ---------------------------------------------------------------------------

WIDE = {65536: SpectrogramConfig(working_sample_rate=96000),
        131072: SpectrogramConfig(working_sample_rate=192000)}
ALL_PASSES = [(f"bf16x{a}", f"bf16x{b}") for a in (1, 3, 4, 6) for b in (1, 3, 4, 6)]


def wide_signals(n_fft, cuda, hops=5, seed=0):
    """Two signals of ``hops`` hops and a few samples at n_fft's rate: frames
    over both reflection edges (a cluster CTA's chunk of them may be
    interior) and interior frames."""
    cfg = WIDE[n_fft]
    return cfg, signals(2, hops * cfg.hop_size + 777, cfg.working_sample_rate, cuda, seed)


@pytest.mark.parametrize("n_fft", sorted(WIDE))
def test_cluster_fft_kernels_match_float64(cuda, n_fft):
    """K1, K3 (float32 and int16 rows) and K6 over a cluster of n_fft / 32768
    CTAs a frame: one launch each, within 1e-5 x each frame's (row's) peak of
    the float64 plain version; K1 then K2 within 1e-4 dB of the float64
    chain; K5 and K5b equal to K1 then K2 (at K2's mode) bit for bit."""
    cfg, waves = wide_signals(n_fft, cuda)
    hop = cfg.hop_size
    window, bands = kernels.stft_window(cfg, cuda), kernels.mel_bands(cfg, cuda)
    assert kernels.stockham_plan(n_fft)["cluster"] == n_fft // 32768
    check_k1(waves, window, hop, n_fft)
    fb64 = torch.from_numpy(mel_ops.mel_filterbank(cfg, np.float64)).to(cuda)
    power = kernels.wave_stft_power(waves, window, hop, n_fft).reshape(-1, n_fft // 2 + 1)
    mel = kernels.mel_log(power, bands)
    ref = kernels.mel_log_plain(kernels.wave_stft_power_plain(
        waves.double(), window, hop, n_fft).reshape(-1, n_fft // 2 + 1), fb64)
    assert float((mel.double() - ref).abs().max()) <= 1e-4
    for mel_precision in (None, "bf16x1", "bf16x3"):
        key = "wave_stft_mel_log" if mel_precision is None else "wave_stft_mel_log_mel_bf16"
        before = kernels.LAUNCHES[key]
        got = kernels.wave_stft_mel_log(waves, window, hop, n_fft, bands, mel_precision)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[key] == before + 1
        assert torch.equal(got.reshape(-1, bands.n_mels), kernels.mel_log(power, bands,
                                                                          mel_precision))
    rows = waves[:, : n_fft + 2 * hop].unfold(1, n_fft, hop).reshape(-1, n_fft).contiguous()
    for x in (rows, (rows * 20000).round().to(torch.int16)):
        before = kernels.LAUNCHES["frames_stft_power"]
        got = kernels.frames_stft_power(x, window, n_fft)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["frames_stft_power"] == before + 1
        want = kernels.frames_stft_power_plain(x, window, n_fft, dtype=torch.float64)
        peak = want.amax(dim=-1, keepdim=True)
        assert bool(((got.double() - want).abs() <= 1e-5 * peak).all())
    before = kernels.LAUNCHES["wave_packed_fft"]
    zr, zi = kernels.wave_packed_fft(waves, window, hop, n_fft)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["wave_packed_fft"] == before + 1
    wr, wi = kernels.wave_packed_fft_plain(waves.double(), window, hop, n_fft)
    peak = torch.hypot(wr, wi).amax(dim=-1, keepdim=True)
    for z, w in ((zr, wr), (zi, wi)):
        assert bool(((z.double() - w).abs() <= 1e-5 * peak).all())


@pytest.mark.parametrize("rows", [1, 7, 600])
@pytest.mark.parametrize("n_fft", sorted(WIDE))
def test_k2_at_wide_bins_matches_float64(cuda, n_fft, rows):
    """K2 (and K4 through it) at 32,769 and 65,537 bins: its ring holds
    chunks, not rows; one launch, within 1e-4 dB of float64."""
    cfg = WIDE[n_fft]
    g = torch.Generator(device=cuda).manual_seed(rows)
    power = torch.rand(rows, cfg.freq_bins, generator=g, device=cuda) ** 4 * 1e3
    before = kernels.LAUNCHES["mel_log"]
    got = kernels.power_to_logmel_cuda(power, cfg)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mel_log"] == before + 1
    fb64 = torch.from_numpy(mel_ops.mel_filterbank(cfg, np.float64)).to(cuda)
    assert float((got.double() - kernels.mel_log_plain(power.double(), fb64)).abs().max()) <= 1e-4


@pytest.mark.parametrize("impl", sorted(kernels.IMPL_KERNELS))
@pytest.mark.parametrize("n_fft", sorted(WIDE))
def test_every_impl_at_96_and_192_khz_launches_its_row(cuda, n_fft, impl):
    """logmel_waveform at 96 and 192 kHz launches exactly IMPL_KERNELS' row
    once each, within 1e-4 dB of the float64 chain (a signal long enough for
    'rollraw''s interior tiles, a multiple of 128 samples)."""
    cfg = WIDE[n_fft]
    sr = cfg.working_sample_rate
    waves = signals(2, 6 * sr, sr, cuda, seed=2)
    kernels.reset_launch_counts()
    got = kernels.logmel_waveform(waves, cfg, impl=impl)
    torch.cuda.synchronize()
    want_launches = dict.fromkeys(kernels.LAUNCHES, 0)
    want_launches.update(dict.fromkeys(kernels.IMPL_KERNELS[impl], 1))
    assert kernels.LAUNCHES == want_launches
    window = kernels.stft_window(cfg, cuda)
    fb64 = torch.from_numpy(mel_ops.mel_filterbank(cfg, np.float64)).to(cuda)
    chain = kernels.wave_stft_mel_log_plain(waves.double(), window, cfg.hop_size, n_fft, fb64)
    assert got.shape == chain.shape
    assert float((got.double() - chain).abs().max()) <= 1e-4


@pytest.mark.parametrize("n_fft", sorted(WIDE))
def test_predictor_and_tick_at_96_and_192_khz(cuda, n_fft):
    """make_batch_predictor at 96 and 192 kHz (K1 and K2 once) against the
    CPU within 1e-4, and the tick's logmel_frames (K3 then K2) within 1e-4
    dB of float64."""
    cfg = WIDE[n_fft]
    sr = cfg.working_sample_rate
    model = CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL, generator=torch.Generator().manual_seed(0))
    pcm = (signals(2, 11 * sr, sr, cuda, seed=3) * 20000).round().to(torch.int16)[..., None]
    with torch.inference_mode():
        feats = featurizer.logmel_features_batch(pcm, cfg)
    mean = feats.mean(dim=(0, 1, 2)).cpu().numpy()
    std = feats.std(dim=(0, 1, 2)).cpu().numpy()
    predict = make_batch_predictor(model, cfg, mean=mean, std=std, device="cuda")
    kernels.reset_launch_counts()
    scores = predict(pcm)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["wave_stft_power"] == 1 and kernels.LAUNCHES["mel_log"] == 1
    cpu = make_batch_predictor(copy.deepcopy(model).cpu(), cfg, mean=mean, std=std, device="cpu")
    assert float((scores.cpu() - cpu(pcm.cpu())).abs().max()) <= 1e-4
    frames = pcm[0, : cfg.nfft + 4 * cfg.hop_size, 0].unfold(0, cfg.nfft, cfg.hop_size)
    frames = frames.contiguous()
    kernels.reset_launch_counts()
    lm = featurizer.logmel_frames(frames, cfg)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["frames_stft_power"] == 1 and kernels.LAUNCHES["mel_log"] == 1
    fb64 = torch.from_numpy(mel_ops.mel_filterbank(cfg, np.float64)).to(cuda)
    want = kernels.mel_log_plain(kernels.frames_stft_power_plain(
        frames, kernels.stft_window(cfg, cuda), cfg.nfft, dtype=torch.float64), fb64)
    assert float((lm.double() - want).abs().max()) <= 1e-4


@pytest.mark.parametrize("precision", ALL_PASSES, ids=str)
@pytest.mark.parametrize("n_fft", [2048, 4096, 8192, 16384, 32768])
def test_fused_tiers_every_size_and_pass_count(cuda, n_fft, precision):
    """K1t's route at every size the fused kernel takes and every (inner,
    outer) pass count, as the library's plan gives it (the split pass, then
    tier_fused_kernel; the tier GEMMs where fused_route declines): K1t on
    frames over both reflection edges and interior ones, K3t on float32 and
    int16 rows, each kernel of the route once a call and every bin within
    tier_tol x the frame's peak of the plain version; tier_fused_kernel at
    every shape that fits (the library's fused_plan), the plan's route or
    not, within the same bound; K5t, K1t's route then K2, equal to K1t then
    K2 bit for bit at each mel_precision."""
    cfg = tier_cfg(n_fft)
    passes = kernels.tier_passes(precision)
    plan = kernels.launch_plan(n_fft, passes=passes)
    route = kernels.tier_route("wave_dft_power_bf16", n_fft, passes)
    fits = kernels.fused_plan(n_fft, passes, 1)
    assert route == ("fused" if fits["fused"] else "gemm") and fits["np"] > 0
    waves = signals(2, 3 * cfg.hop_size + 777, cfg.working_sample_rate, cuda, seed=11)
    window, bands = kernels.stft_window(cfg, cuda), kernels.mel_bands(cfg, cuda)
    hop = cfg.hop_size
    power = launched_once(lambda: kernels.wave_dft_power_bf16(waves, window, hop, n_fft,
                                                              precision),
                          *plan["wave_dft_power_bf16"]["kernels"])
    want = kernels.wave_dft_power_bf16_plain(waves, window, hop, n_fft, precision)
    peak = want.amax(dim=-1, keepdim=True)
    rel = float(((power - want).abs() / peak).max())
    assert rel <= tier_tol(precision), rel
    fused = torch.empty_like(power)
    rows = waves.shape[0] * fused.shape[1]
    kernels._tier_fused("wave_dft_power_bf16", waves, 0, window, fused, rows, waves.shape[1],
                        fused.shape[1], hop, n_fft, passes)
    rel = float(((fused - want).abs() / peak).max())
    assert rel <= tier_tol(precision), ("tier_fused_kernel", rel)
    g = torch.Generator(device=cuda).manual_seed(12)
    rows = 0.3 * torch.randn(5, n_fft, generator=g, device=cuda)
    for x in (rows, (rows * 8000).round().to(torch.int16)):
        got = launched_once(lambda: kernels.frames_dft_power_bf16(x, window, n_fft, precision),
                            *plan["frames_dft_power_bf16"]["kernels"])
        want = kernels.frames_dft_power_bf16_plain(x, window, n_fft, precision)
        rel = float(((got - want).abs() / want.amax(dim=-1, keepdim=True)).max())
        assert rel <= tier_tol(precision), (x.dtype, rel)
    assert plan["wave_stft_mel_log_bf16"]["route"] == "chain"
    for mel_precision in (None, "bf16x1", "bf16x3"):
        mel = "mel_log_bf16" if kernels.mel_passes(mel_precision) else "mel_log"
        got = launched_once(lambda: kernels.wave_stft_mel_log_bf16(
            waves, window, hop, n_fft, bands, precision, mel_precision),
            *plan["wave_stft_mel_log_bf16"]["kernels"][:-1], mel)
        two = kernels.mel_log(power.reshape(-1, n_fft // 2 + 1), bands, mel_precision)
        assert torch.equal(got.reshape(-1, bands.n_mels), two), mel_precision


@pytest.mark.parametrize("precision", ALL_PASSES, ids=str)
@pytest.mark.parametrize("n_fft", sorted(WIDE))
def test_wide_k1t_matches_its_plain_version(cuda, n_fft, precision):
    """K1t at n1 = 256 (n2 256 and 512) at every pass count of each stage:
    the route the library's plan gives (the tier GEMMs: no fused shape fits
    there), each of its kernels once, within tier_tol x each frame's peak of
    the plain version."""
    cfg, waves = wide_signals(n_fft, cuda, hops=3)
    window = kernels.stft_window(cfg, cuda)
    assert kernels.tier_route("wave_dft_power_bf16", n_fft) == "gemm"
    got = launched_once(lambda: kernels.wave_dft_power_bf16(waves, window, cfg.hop_size, n_fft,
                                                            precision),
                        *kernels.launch_plan(n_fft)["wave_dft_power_bf16"]["kernels"])
    want = kernels.wave_dft_power_bf16_plain(waves, window, cfg.hop_size, n_fft, precision)
    assert got.shape == want.shape
    peak = want.amax(dim=-1, keepdim=True)
    rel = float(((got - want).abs() / peak.clamp_min(1e-30)).max())
    assert rel <= tier_tol(precision), rel


@pytest.mark.parametrize("precision", ["bf16x3", "bf16x1"])
@pytest.mark.parametrize("n_fft", sorted(WIDE))
def test_wide_k1t_runs_its_own_mode(cuda, n_fft, precision):
    """On broadband noise, K1t at n1 = 256 lies nearer its own mode's plain
    version than the next mode's, and at the next mode nearer that one's."""
    cfg, _ = wide_signals(n_fft, cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    noise = 0.3 * torch.randn(2, 3 * cfg.hop_size + 777, generator=g, device=cuda)
    window = kernels.stft_window(cfg, cuda)
    got = kernels.wave_dft_power_bf16(noise, window, cfg.hop_size, n_fft, precision)
    want, neighbour = (kernels.wave_dft_power_bf16_plain(noise, window, cfg.hop_size, n_fft, p)
                       for p in (precision, TIER_NEIGHBOUR[precision]))
    peak = want.amax(dim=-1, keepdim=True)
    assert abs(kernels.mode_fraction(got, want, neighbour, peak)) <= MODE_FRACTION_TOL
    at_next = kernels.wave_dft_power_bf16(noise, window, cfg.hop_size, n_fft,
                                          TIER_NEIGHBOUR[precision])
    assert kernels.mode_fraction(at_next, want, neighbour, peak) >= 1 - MODE_FRACTION_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
@pytest.mark.parametrize("precision", ["bf16x3", "bf16x6", ("bf16x1", "bf16x6")], ids=str)
@pytest.mark.parametrize("n_fft", sorted(WIDE))
def test_wide_k3t_matches_its_plain_version(cuda, n_fft, precision, dtype):
    g = torch.Generator(device=cuda).manual_seed(3)
    rows = 0.3 * torch.randn(12, n_fft, generator=g, device=cuda)
    if dtype == torch.int16:
        rows = (rows * 8000).round().to(torch.int16)
    window = kernels.stft_window(WIDE[n_fft], cuda)
    got = launched_once(lambda: kernels.frames_dft_power_bf16(rows, window, n_fft, precision),
                        *kernels.launch_plan(n_fft)["frames_dft_power_bf16"]["kernels"])
    want = kernels.frames_dft_power_bf16_plain(rows, window, n_fft, precision)
    rel = float(((got - want).abs() / want.amax(dim=-1, keepdim=True)).max())
    assert rel <= tier_tol(precision), rel


@pytest.mark.parametrize("precision, mel_precision",
                         FUSE_MODES + [("bf16x6", "bf16x1"), (("bf16x3", "bf16x6"), None)],
                         ids=str)
@pytest.mark.parametrize("n_fft", sorted(WIDE))
def test_wide_k5t_equals_k1t_then_k2(cuda, n_fft, precision, mel_precision):
    """K5t at n1 = 256: K1t's route (the tier GEMMs), then K2, each kernel
    once; equal to K1t then K2 at mel_precision's mode bit for bit."""
    cfg, waves = wide_signals(n_fft, cuda, hops=3)
    window, bands = kernels.stft_window(cfg, cuda), kernels.mel_bands(cfg, cuda)
    route = kernels.launch_plan(n_fft)["wave_stft_mel_log_bf16"]
    assert route["route"] == "chain"
    mel = "mel_log_bf16" if kernels.mel_passes(mel_precision) else "mel_log"
    got = launched_once(lambda: kernels.wave_stft_mel_log_bf16(
        waves, window, cfg.hop_size, n_fft, bands, precision, mel_precision),
        *route["kernels"][:-1], mel)
    power = kernels.wave_dft_power_bf16(waves, window, cfg.hop_size, n_fft, precision)
    two = kernels.mel_log(power.reshape(-1, n_fft // 2 + 1), bands, mel_precision)
    assert torch.equal(got.reshape(-1, bands.n_mels), two)


@pytest.mark.parametrize("precision", ALL_PASSES, ids=str)
@pytest.mark.parametrize("n_fft", [4096, 8192, 16384, 32768, 65536, 131072])
def test_k6t_every_size_and_pass_count(cuda, n_fft, precision):
    """The wgmma K6t at log2 m 11..16 (n1 32..256) and every pass count of
    each stage (each instance's shape, packed_plan): one launch, every bin
    within tier_tol x the frame's peak |Z| of the plain version, on frames
    over both reflection edges and interior ones."""
    cfg = WIDE.get(n_fft) or tier_cfg(n_fft)
    waves = signals(2, 3 * cfg.hop_size + 777, cfg.working_sample_rate, cuda, seed=9)
    window = kernels.stft_window(cfg, cuda)
    before = kernels.LAUNCHES["wave_packed_fft_bf16"]
    zr, zi = kernels.wave_packed_fft_bf16(waves, window, cfg.hop_size, n_fft, precision)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["wave_packed_fft_bf16"] == before + 1
    wr, wi = kernels.wave_packed_fft_bf16_plain(waves, window, cfg.hop_size, n_fft, precision)
    assert zr.shape == wr.shape == (2, 1 + waves.shape[1] // cfg.hop_size, n_fft // 2)
    peak = torch.hypot(wr, wi).amax(dim=-1, keepdim=True)
    rel = max(float(((z - w).abs() / peak).max()) for z, w in ((zr, wr), (zi, wi)))
    assert rel <= tier_tol(precision), rel


# ---------------------------------------------------------------------------
# The ends of the range: n_fft 2^18, 2^19, 2^20 (384 kHz to 1.536 MHz: the
# Stockham FFT's global cross pass, the tier GEMMs, K5 and K5t as chains, K2
# at up to 524,289 bins) and the tiers' small end (n_fft 128..1024, K6t
# 256..2048: the tier GEMMs)
# ---------------------------------------------------------------------------

TOP = {262144: SpectrogramConfig(working_sample_rate=384000),
       524288: SpectrogramConfig(working_sample_rate=768000),
       1048576: SpectrogramConfig(working_sample_rate=1536000)}
# The tiers' small end: a rate whose n_fft is each size and whose hop is even.
LOW = {128: SpectrogramConfig(working_sample_rate=122), 256: SpectrogramConfig(working_sample_rate=250),
       512: SpectrogramConfig(working_sample_rate=400), 1024: SpectrogramConfig(working_sample_rate=1000),
       2048: SpectrogramConfig(working_sample_rate=2000)}
GEMM_PASSES = ["bf16x3", "bf16x1", "bf16x6", ("bf16x4", "bf16x1"), ("bf16x1", "bf16x3"),
               ("bf16x6", "bf16x4")]


def launched_once(fn, *names):
    """fn() with the launch counts reset just before; asserts exactly
    ``names`` launched, once each; returns fn()'s result."""
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    want.update(dict.fromkeys(names, 1))
    assert kernels.LAUNCHES == want
    return out


def top_signals(n_fft, cuda, hops=3, seed=0):
    """Two signals of ``hops`` hops and a few samples: frames over both
    reflection edges and interior ones."""
    cfg = TOP[n_fft]
    return cfg, signals(2, hops * cfg.hop_size + 777, cfg.working_sample_rate, cuda, seed)


@pytest.mark.parametrize("n_fft", sorted(TOP))
def test_cross_pass_kernels_match_float64(cuda, n_fft):
    """K1, K3 (float32 and int16 rows) and K6 through the cross pass into 2,
    4 or 8 sub-rows (launches: the pass, the sub-rows, and K1's and K3's
    unpack; none under the wrapper's own name), within 1e-5 x each frame's (row's) peak of the
    float64 plain version; K1 then K2 within 1e-4 dB of the float64 chain;
    K5 and K5b, K1's launches then K2 at its mode, equal to K1 then K2."""
    cfg, waves = top_signals(n_fft, cuda)
    hop, bins = cfg.hop_size, n_fft // 2 + 1
    window, bands = kernels.stft_window(cfg, cuda), kernels.mel_bands(cfg, cuda)
    assert kernels.stockham_plan(n_fft)["cross"] == n_fft // 131072
    cross = ("fft_cross_pass", "fft_subrows")
    power = launched_once(lambda: kernels.wave_stft_power(waves, window, hop, n_fft),
                          *cross, "packed_power")
    want = kernels.wave_stft_power_plain(waves.double(), window, hop, n_fft)
    peak = want.amax(dim=-1, keepdim=True)
    assert bool(((power.double() - want).abs() <= 1e-5 * peak).all())
    fb64 = torch.from_numpy(mel_ops.mel_filterbank(cfg, np.float64)).to(cuda)
    rows = power.reshape(-1, bins)
    mel = kernels.mel_log(rows, bands)
    assert float((mel.double() - kernels.mel_log_plain(want.reshape(-1, bins), fb64)).abs().max()) <= 1e-4
    for mel_precision in (None, "bf16x1", "bf16x3"):
        k2 = "mel_log" if mel_precision is None else "mel_log_bf16"
        got = launched_once(lambda: kernels.wave_stft_mel_log(waves, window, hop, n_fft, bands,
                                                              mel_precision),
                            *cross, "packed_power", k2)
        assert torch.equal(got.reshape(-1, bands.n_mels), kernels.mel_log(rows, bands,
                                                                          mel_precision))
    frames = waves[:, : n_fft + 2 * hop].unfold(1, n_fft, hop).reshape(-1, n_fft).contiguous()
    for x in (frames, (frames * 20000).round().to(torch.int16)):
        got = launched_once(lambda: kernels.frames_stft_power(x, window, n_fft),
                            *cross, "packed_power")
        want = kernels.frames_stft_power_plain(x, window, n_fft, dtype=torch.float64)
        assert bool(((got.double() - want).abs() <= 1e-5 * want.amax(dim=-1, keepdim=True)).all())
    zr, zi = launched_once(lambda: kernels.wave_packed_fft(waves, window, hop, n_fft),
                           *cross)
    wr, wi = kernels.wave_packed_fft_plain(waves.double(), window, hop, n_fft)
    peak = torch.hypot(wr, wi).amax(dim=-1, keepdim=True)
    for z, w in ((zr, wr), (zi, wi)):
        assert bool(((z.double() - w).abs() <= 1e-5 * peak).all())


@pytest.mark.parametrize("rows", [1, 7, 600])
@pytest.mark.parametrize("n_fft", sorted(TOP))
def test_k2_at_top_bins_matches_float64(cuda, n_fft, rows):
    """K2 at 131,073, 262,145 and 524,289 bins (1,010, 1,973 and 3,897
    segments: four rows at a time where their sums fit beside the ring, one
    at 2^20): one launch, within 1e-4 dB of float64."""
    cfg = TOP[n_fft]
    g = torch.Generator(device=cuda).manual_seed(rows)
    power = torch.rand(rows, cfg.freq_bins, generator=g, device=cuda) ** 4 * 1e3
    got = launched_once(lambda: kernels.power_to_logmel_cuda(power, cfg), "mel_log")
    fb64 = torch.from_numpy(mel_ops.mel_filterbank(cfg, np.float64)).to(cuda)
    assert float((got.double() - kernels.mel_log_plain(power.double(), fb64)).abs().max()) <= 1e-4


@pytest.mark.parametrize("impl", sorted(kernels.IMPL_KERNELS))
@pytest.mark.parametrize("n_fft", sorted(TOP))
def test_every_impl_at_top_rates_launches_its_row(cuda, n_fft, impl):
    """logmel_waveform at 384 kHz, 768 kHz and 1.536 MHz launches exactly
    ``impl_kernels(impl, n_fft=n_fft)`` once each, within 1e-4 dB of the
    float64 chain (a signal long enough for 'rollraw''s interior tiles)."""
    cfg = TOP[n_fft]
    sr = cfg.working_sample_rate
    waves = signals(2, 6 * sr, sr, cuda, seed=2)
    got = launched_once(lambda: kernels.logmel_waveform(waves, cfg, impl=impl),
                        *kernels.impl_kernels(impl, n_fft=n_fft))
    window = kernels.stft_window(cfg, cuda)
    fb64 = torch.from_numpy(mel_ops.mel_filterbank(cfg, np.float64)).to(cuda)
    chain = kernels.wave_stft_mel_log_plain(waves.double(), window, cfg.hop_size, n_fft, fb64)
    assert got.shape == chain.shape
    assert float((got.double() - chain).abs().max()) <= 1e-4


@pytest.mark.parametrize("n_fft", sorted(TOP))
def test_predictor_and_tick_at_top_rates(cuda, n_fft):
    """make_batch_predictor (K1's launches and K2 once each) against the CPU
    within 1e-4, and the tick's logmel_frames (K3's and K2) within 1e-4 dB
    of float64."""
    cfg = TOP[n_fft]
    sr = cfg.working_sample_rate
    model = CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL, generator=torch.Generator().manual_seed(0))
    pcm = (signals(2, 6 * sr, sr, cuda, seed=3) * 20000).round().to(torch.int16)[..., None]
    with torch.inference_mode():
        feats = featurizer.logmel_features_batch(pcm, cfg)
    mean = feats.mean(dim=(0, 1, 2)).cpu().numpy()
    std = feats.std(dim=(0, 1, 2)).cpu().numpy()
    predict = make_batch_predictor(model, cfg, mean=mean, std=std, device="cuda")
    scores = launched_once(lambda: predict(pcm), *kernels.impl_kernels("roll", n_fft=n_fft))
    cpu = make_batch_predictor(copy.deepcopy(model).cpu(), cfg, mean=mean, std=std, device="cpu")
    assert float((scores.cpu() - cpu(pcm.cpu())).abs().max()) <= 1e-4
    frames = pcm[0, : cfg.nfft + 4 * cfg.hop_size, 0].unfold(0, cfg.nfft, cfg.hop_size)
    frames = frames.contiguous()
    lm = launched_once(lambda: featurizer.logmel_frames(frames, cfg), "fft_cross_pass",
                       "fft_subrows", "packed_power", "mel_log")
    fb64 = torch.from_numpy(mel_ops.mel_filterbank(cfg, np.float64)).to(cuda)
    want = kernels.mel_log_plain(kernels.frames_stft_power_plain(
        frames, kernels.stft_window(cfg, cuda), cfg.nfft, dtype=torch.float64), fb64)
    assert float((lm.double() - want).abs().max()) <= 1e-4


def gemm_case(n_fft, cuda, seed=0):
    cfg = TOP.get(n_fft) or LOW[n_fft]
    sr = cfg.working_sample_rate
    return cfg, signals(2, 3 * cfg.hop_size + 77, sr, cuda, seed)


@pytest.mark.parametrize("precision", GEMM_PASSES, ids=str)
@pytest.mark.parametrize("n_fft", [128, 256, 512, 1024] + sorted(TOP))
def test_gemm_k1t_and_k3t_match_their_plain_versions(cuda, n_fft, precision):
    """K1t and K3t (float32 and int16 rows) through the tier GEMMs
    (tier_split, tier_inner, tier_outer once each): every bin within
    tier_tol x the frame's peak of the plain version."""
    cfg, waves = gemm_case(n_fft, cuda)
    hop, window = cfg.hop_size, kernels.stft_window(cfg, cuda)
    got = launched_once(lambda: kernels.wave_dft_power_bf16(waves, window, hop, n_fft, precision),
                        *kernels.GEMM_KERNELS)
    want = kernels.wave_dft_power_bf16_plain(waves, window, hop, n_fft, precision)
    assert got.shape == want.shape == (2, 1 + waves.shape[1] // hop, n_fft // 2 + 1)
    rel = float(((got - want).abs() / want.amax(dim=-1, keepdim=True).clamp_min(1e-30)).max())
    assert rel <= tier_tol(precision), rel
    rows = signals(2, n_fft + 2 * hop, cfg.working_sample_rate, cuda, seed=4)
    frames = rows.unfold(1, n_fft, hop).reshape(-1, n_fft).contiguous()
    for x in (frames, (frames * 8000).round().to(torch.int16)):
        got = launched_once(lambda: kernels.frames_dft_power_bf16(x, window, n_fft, precision),
                            *kernels.GEMM_KERNELS)
        want = kernels.frames_dft_power_bf16_plain(x, window, n_fft, precision)
        rel = float(((got - want).abs() / want.amax(dim=-1, keepdim=True)).max())
        assert rel <= tier_tol(precision), rel


@pytest.mark.parametrize("precision", ["bf16x3", "bf16x1"])
@pytest.mark.parametrize("n_fft", [128, 1024] + sorted(TOP))
def test_gemm_k1t_runs_its_own_mode(cuda, n_fft, precision):
    """On broadband noise the tier GEMMs' K1t lies nearer its own mode's
    plain version than the next mode's, and at the next mode nearer that
    one's."""
    cfg = TOP.get(n_fft) or LOW[n_fft]
    g = torch.Generator(device=cuda).manual_seed(5)
    noise = 0.3 * torch.randn(4, 5 * cfg.hop_size + 77, generator=g, device=cuda)
    window, hop = kernels.stft_window(cfg, cuda), cfg.hop_size
    got = kernels.wave_dft_power_bf16(noise, window, hop, n_fft, precision)
    want, neighbour = (kernels.wave_dft_power_bf16_plain(noise, window, hop, n_fft, p)
                       for p in (precision, TIER_NEIGHBOUR[precision]))
    peak = want.amax(dim=-1, keepdim=True)
    assert abs(kernels.mode_fraction(got, want, neighbour, peak)) <= MODE_FRACTION_TOL
    at_next = kernels.wave_dft_power_bf16(noise, window, hop, n_fft, TIER_NEIGHBOUR[precision])
    assert kernels.mode_fraction(at_next, want, neighbour, peak) >= 1 - MODE_FRACTION_TOL


@pytest.mark.parametrize("precision", GEMM_PASSES, ids=str)
@pytest.mark.parametrize("n_fft", [256, 512, 1024, 2048] + sorted(TOP))
def test_gemm_k6t_matches_its_plain_version(cuda, n_fft, precision):
    """K6t through the tier GEMMs over m = n_fft / 2 packed points (n1 8 ..
    512): every bin within tier_tol x the frame's peak |Z|."""
    cfg, waves = gemm_case(n_fft, cuda, seed=9)
    hop, window = cfg.hop_size, kernels.stft_window(cfg, cuda)
    zr, zi = launched_once(lambda: kernels.wave_packed_fft_bf16(waves, window, hop, n_fft,
                                                                precision),
                           *kernels.GEMM_KERNELS)
    wr, wi = kernels.wave_packed_fft_bf16_plain(waves, window, hop, n_fft, precision)
    assert zr.shape == wr.shape == (2, 1 + waves.shape[1] // hop, n_fft // 2)
    peak = torch.hypot(wr, wi).amax(dim=-1, keepdim=True)
    rel = max(float(((z - w).abs() / peak).max()) for z, w in ((zr, wr), (zi, wi)))
    assert rel <= tier_tol(precision), rel


def test_gemm_frame_groups_on_the_card(cuda):
    """K1t at 2^20 and bf16x6 over more frames than the library's plan puts
    in a group (gemm_plan, its scratch within 2 GiB): each of the tier
    GEMMs' kernels launched once a group, every frame within tier_tol of the
    plain version."""
    n_fft = 1 << 20
    cfg = TOP[n_fft]
    hop, window = cfg.hop_size, kernels.stft_window(cfg, cuda)
    plan = kernels.gemm_plan(n_fft, False, (6, 6), 1 << 20)
    waves = signals(1, (plan["group_frames"] + 8) * hop, cfg.working_sample_rate, cuda, seed=11)
    frames = 1 + waves.shape[1] // hop
    groups = kernels.frame_groups(frames, kernels.gemm_plan(n_fft, False, (6, 6), frames)
                                  ["group_frames"])
    assert len(groups) == 2
    assert kernels.gemm_plan(n_fft, False, (6, 6), frames)["scratch_bytes"] <= 1 << 31
    kernels.reset_launch_counts()
    got = kernels.wave_dft_power_bf16(waves, window, hop, n_fft, "bf16x6")
    torch.cuda.synchronize()
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == dict.fromkeys(
        kernels.GEMM_KERNELS, len(groups))
    want = kernels.wave_dft_power_bf16_plain(waves, window, hop, n_fft, "bf16x6")
    rel = float(((got - want).abs() / want.amax(dim=-1, keepdim=True).clamp_min(1e-30)).max())
    assert rel <= tier_tol("bf16x6"), rel


@pytest.mark.parametrize("precision, mel_precision", FUSE_MODES, ids=str)
@pytest.mark.parametrize("n_fft", sorted(TOP))
def test_top_k5t_equals_k1t_then_k2(cuda, n_fft, precision, mel_precision):
    """K5t above 131072 (a frame's n2 / 64 blocks exceed a cluster): K1t's
    GEMMs, then K2 at mel_precision's mode, once each; equal to K1t then K2
    bit for bit."""
    cfg, waves = top_signals(n_fft, cuda)
    window, bands = kernels.stft_window(cfg, cuda), kernels.mel_bands(cfg, cuda)
    k2 = "mel_log_bf16" if kernels.mel_passes(mel_precision) else "mel_log"
    got = launched_once(lambda: kernels.wave_stft_mel_log_bf16(
        waves, window, cfg.hop_size, n_fft, bands, precision, mel_precision),
        *kernels.GEMM_KERNELS, k2)
    power = kernels.wave_dft_power_bf16(waves, window, cfg.hop_size, n_fft, precision)
    two = kernels.mel_log(power.reshape(-1, n_fft // 2 + 1), bands, mel_precision)
    assert torch.equal(got.reshape(-1, bands.n_mels), two)


# Each impl at the sizes where sed_tpu computes it ('pack' from 256, 'fuse'
# from 2048).
FAST_IMPL_CASES = [(n, impl) for n in [128, 256, 1024, 2048] + sorted(TOP)
                   for impl in ("roll", "eo", "pack", "fuse")
                   if not (impl == "pack" and n < 256) and not (impl == "fuse" and n < 2048)]


@pytest.mark.parametrize("n_fft, impl", FAST_IMPL_CASES, ids=str)
def test_impls_at_fast_launch_their_row_at_every_size(cuda, n_fft, impl):
    """logmel_waveform at fast launches exactly ``impl_kernels(impl,
    'bf16x3', n_fft=n_fft)`` once each, within 1e-3 dB of the chain of the
    plain versions on the card on broadband noise; the tick's logmel_frames
    at fast likewise (K3t's launches and K2)."""
    cfg = TOP.get(n_fft) or LOW[n_fft]
    hop, window = cfg.hop_size, kernels.stft_window(cfg, cuda)
    fb = kernels.mel_bands(cfg, cuda).dense
    g = torch.Generator(device=cuda).manual_seed(7)
    noise = 0.3 * torch.randn(2, 4 * hop + 77, generator=g, device=cuda)
    got = launched_once(lambda: kernels.logmel_waveform(noise, cfg, impl=impl, precision="bf16x3"),
                        *kernels.impl_kernels(impl, "bf16x3", n_fft=n_fft))
    if impl == "pack":
        power = kernels.packed_power_onesided(*kernels.wave_packed_fft_bf16_plain(
            noise, window, hop, n_fft, "bf16x3"), n_fft)
        want = kernels.mel_log_plain(power.reshape(-1, n_fft // 2 + 1), fb).reshape(got.shape)
    else:
        want = kernels.wave_stft_mel_log_bf16_plain(noise, window, hop, n_fft, fb, "bf16x3")
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-3
    rows = noise[:, : n_fft + 2 * hop].unfold(1, n_fft, hop).reshape(-1, n_fft).contiguous()
    tick = launched_once(lambda: featurizer.logmel_frames(rows, cfg, "bf16x3"),
                         *kernels.launch_plan(n_fft)["frames_dft_power_bf16"]["kernels"],
                         "mel_log")
    want = kernels.mel_log_plain(kernels.frames_dft_power_bf16_plain(rows, window, n_fft,
                                                                     "bf16x3"), fb)
    assert float((tick - want).abs().max()) <= 1e-3


@pytest.mark.parametrize("log2_n", range(2, 21))
def test_launch_plan_from_the_library_within_shared_memory(cuda, log2_n):
    """launch_plan on the card, where K2's rows at once and shared memory
    come from the library (sed_mel_plan, the rule K2 launches by): every
    kernel's plan known and within 232,448 B at every power of two 4..2^20
    and every pass count of the tiers, with the 64-band bank's segments at
    that size; K2 four rows at a time up to 2^19 (524,289 bins), one at 2^20,
    and one for a few rows."""
    n_fft = 1 << log2_n
    n_seg = 1
    if n_fft >= 64:   # a rate whose frame is 3/4 of n_fft
        cfg = SpectrogramConfig(working_sample_rate=int(0.75 * n_fft / 0.66))
        assert cfg.nfft == n_fft
        n_seg = kernels.mel_bands(cfg, torch.device("cpu")).n_segments
    for passes in ALL_PASSES:
        passes = kernels.tier_passes(passes)
        plan = kernels.launch_plan(n_fft, n_seg, passes=passes)
        assert all(p["smem"] is not None and p["smem"] <= 232448 for p in plan.values()), plan
        # K1t's and K3t's route from the library's fused plan: the split pass
        # then the fused kernel at n_fft 2048..32768 where fused_route takes
        # the passes, else the tier GEMMs; K5t K1t's route, then K2.
        for name in ("wave_dft_power_bf16", "frames_dft_power_bf16", "wave_stft_mel_log_bf16"):
            if log2_n not in kernels.TIER_RANGES[name]:
                continue
            fused = log2_n in range(11, 16) and kernels.fused_plan(n_fft, passes, 1)["fused"]
            if name == "wave_stft_mel_log_bf16":
                assert plan[name]["route"] == "chain"
                assert plan[name]["kernels"][-1] == "mel_log"
            elif fused:
                assert plan[name]["route"] == "fused"
                assert plan[name]["kernels"] == ("tier_split", name)
            else:
                assert plan[name]["route"] == "gemm"
            assert plan[name]["cluster"] == 1
    many = 4 if n_fft <= 524288 else 1
    assert plan["mel_log"]["instance"] == f"mel_log_kernel<{many}, kPasses>"
    assert kernels.mel_plan(n_seg, 64, rows=7)["rows_at_once"] == 1
