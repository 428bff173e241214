"""The ends of the n_fft range on the CPU, held against sed_tpu.

On a CUDA tensor these sizes run the routes beyond the one-launch instances:
above n_fft 131072 the Stockham FFT's global cross pass (K1, K3, K6;
K5 as K1 then K2) and the tier GEMMs (K1t, K3t, K6t; K5t as K1t then K2), and
at the tiers' small end (n_fft 128..1024, K6t 256..2048) the tier GEMMs.
Here, on CPU tensors, their plain versions run, on seeded numpy input of one
signal of two hops (3 frames), against sed_tpu's Pallas kernels in
interpret mode (each call takes seconds, so one sed_tpu call a size and
class, made once a module):

  * 384 kHz (n_fft 262144): ``logmel_waveform`` at 'roll', 'fuse' and 'pack'
    at parity (1e-4 dB of sed_tpu's parity 'fuse') and fast (1e-3 dB of its
    fast 'fuse'); ``make_batch_predictor`` within 1e-5 of sed_tpu's;
  * 1.536 MHz (n_fft 2^20): 'pack' at parity against sed_tpu's 'pack';
  * 125 Hz (n_fft 128) and 1 kHz (n_fft 1024) at fast: the tick's
    ``logmel_frames`` (int16 rows), and at 1 kHz 'roll' and 'pack', each
    against sed_tpu's same call (1e-3 dB); 'roll' at 125 Hz in the power
    class of ``test_torch_featurizer_tiers.py`` (2e-5 x the frame's peak),
    and within 1e-3 of each bin's own power, as its log-mel is not in the
    fast class there: on the CPU sed_tpu's fast keeps its lo chunk in
    float32 where the TPU and the port round it to bf16, and 3 of the 192
    log-mel values, in bands ~38 dB under the frame's peak, differ by up to
    1.9e-3 dB (the port's plain fast is 3.3e-3 dB from float64 there,
    sed_tpu's CPU fast 1.4e-3 dB); so its log-mel is held within 1e-3 dB of
    the TPU's rounding emulated in float64 (sed_tpu's bf16 chunk products,
    every other step in float64; 1.1e-4 dB);
  * the smallest sizes: sed_tpu's kernels refuse n_fft 64 ('roll': its
    tiles are 128 lanes of a frame) and 'pack' at n_fft 128 (128 lanes of
    the 64 packed points), which is why the tier kernels start at 128 and
    256;
  * ``cuda_featurizer.launch_plan`` at every power of two 4..2^20 (within
    227 KB, the routes each kernel takes), and its refusal above 2^20, as
    the wrappers refuse.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_tpu.configs import SpectrogramConfig as JaxSpectrogramConfig
from sed_tpu.inference import make_batch_predictor as jax_make_batch_predictor
from sed_tpu.models.cnn import CnnAvgPooling as FlaxCnnAvgPooling
from sed_tpu.ops import pallas_featurizer as jax_pallas
from sed_tpu_torch.configs import SpectrogramConfig
from sed_tpu_torch.inference import make_batch_predictor
from sed_tpu_torch.models.cnn import CnnAvgPooling
from sed_tpu_torch.models.convert import cnn_avg_pooling_state_dict
from sed_tpu_torch.ops import cuda_featurizer as kernels
from sed_tpu_torch.ops import featurizer
from sed_tpu_torch.ops import mel as mel_ops
from sed_tpu_torch.ops import stft as stft_ops

PARITY_DB, FAST_DB = 1e-4, 1e-3
SED_TPU_POWER = 2e-5   # x the frame's peak power: the fast class of K1t's power
SED_TPU_BIN = 1e-3     # x each bin's own power (0.0043 dB), at 125 Hz against sed_tpu
NARROW = ((8, 2), (16, 1))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(sr):
    return SpectrogramConfig(working_sample_rate=sr), JaxSpectrogramConfig(working_sample_rate=sr)


def signal(sr, hops=2, seed=0) -> np.ndarray:
    """(1, hops * hop) f32: noise and a tone at a tenth of the rate."""
    cfg = configs(sr)[0]
    n = hops * cfg.hop_size
    rng = np.random.default_rng(seed + sr)
    x = 0.3 * rng.standard_normal(n) + 0.4 * np.sin(2 * np.pi * 0.1 * np.arange(n))
    return x[None].astype(np.float32)


def tick_rows(sr) -> np.ndarray:
    """(3, n_fft) int16 rows of a signal, a quarter hop apart."""
    cfg = configs(sr)[0]
    x = signal(sr, hops=4, seed=2)[0]
    rows = np.stack([x[i * cfg.hop_size // 4:][: cfg.nfft] for i in range(3)])
    return (np.clip(rows, -1, 1) * 32767).astype(np.int16)


def natural(flat: np.ndarray, n: int) -> np.ndarray:
    """sed_tpu's (k2, k1) layout of all n bins (index k2*n1 + k1 holds bin
    n2*k1 + k2) -> the one-sided bins in natural order."""
    n1 = 1 << ((n.bit_length() - 1) // 2)
    n2 = n // n1
    out = np.empty_like(flat)
    out[..., (n2 * np.arange(n1)[None, :] + np.arange(n2)[:, None]).reshape(-1)] = flat
    return out[..., : n // 2 + 1]


@pytest.fixture(scope="module")
def sed_tpu_call():
    """sed_tpu's log-mel (interpret mode) of ``signal(sr)`` by
    ``logmel_waveform_pallas(impl=impl, precision=precision)``, or of
    ``tick_rows(sr)`` by ``logmel_frames_pallas`` (impl 'tick'), each
    computed once; impl 'power': ``stft_power_from_waveform_pallas`` at
    'roll', its (k2, k1) layout of all n_fft bins in the one-sided natural
    order."""
    cache = {}

    def get(sr, impl, precision):
        key = (sr, impl, precision)
        if key not in cache:
            jcfg = configs(sr)[1]
            if impl == "power":
                out = natural(np.asarray(jax_pallas.stft_power_from_waveform_pallas(
                    jnp.asarray(signal(sr)), jcfg, impl="roll", precision=precision)),
                    jcfg.nfft)
            elif impl == "tick":
                out = jax_pallas.logmel_frames_pallas(jnp.asarray(tick_rows(sr)), jcfg,
                                                      precision=precision)
            else:
                out = jax_pallas.logmel_waveform_pallas(jnp.asarray(signal(sr)), jcfg, impl=impl,
                                                        precision=precision)
            cache[key] = np.asarray(out)
        return cache[key]

    return get


@pytest.mark.parametrize("precision, atol", [(None, PARITY_DB), ("bf16x3", FAST_DB)], ids=str)
def test_384k_impls_match_sed_tpu(precision, atol, sed_tpu_call):
    """'roll', 'fuse' and 'pack' at 384 kHz against sed_tpu's 'fuse' at the
    same precision."""
    sr = 384000
    cfg = configs(sr)[0]
    assert cfg.nfft == 262144
    want = sed_tpu_call(sr, "fuse", precision)
    assert want.shape == (1, 3, cfg.mel_bins)
    for impl in ("roll", "fuse", "pack"):
        got = kernels.logmel_waveform(torch.from_numpy(signal(sr)), cfg, impl=impl,
                                      precision=precision).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=impl)


def test_384k_batch_predictor_matches_sed_tpu():
    """logmel_features_batch, then a CnnAvgPooling with the same seeded
    weights, on an int16 clip of 6 hops (7 frames): scores within 1e-5."""
    cfg, jcfg = configs(384000)
    flax_model = FlaxCnnAvgPooling(classes_num=1, model_config=NARROW)
    variables = flax_model.init(jax.random.key(0), jnp.zeros((1, 7, 64, 1)), train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    port = CnnAvgPooling(1, NARROW)
    port.load_state_dict(cnn_avg_pooling_state_dict(params, stats), strict=True)
    x = (np.clip(signal(384000, hops=6, seed=1)[..., None], -1, 1) * 32767).astype(np.int16)
    want = np.asarray(jax_make_batch_predictor(flax_model, jcfg)(params, stats, jnp.asarray(x)))
    got = make_batch_predictor(port, cfg, device="cpu")(x).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_1536k_pack_matches_sed_tpu(sed_tpu_call):
    """'pack' at parity at n_fft 2^20, the largest size, against sed_tpu's
    'pack' (its packed FFT, then the hermitian unpack and the mel)."""
    sr = 1536000
    cfg = configs(sr)[0]
    assert cfg.nfft == 1 << 20
    want = sed_tpu_call(sr, "pack", None)
    got = kernels.logmel_waveform(torch.from_numpy(signal(sr)), cfg, impl="pack").numpy()
    assert got.shape == want.shape == (1, 3, cfg.mel_bins)
    np.testing.assert_allclose(got, want, rtol=0, atol=PARITY_DB)


SMALL = [(125, "power"), (125, "tick"), (1000, "roll"), (1000, "tick"), (1000, "pack")]


@pytest.mark.parametrize("sr, impl", SMALL, ids=str)
def test_small_n_fft_at_fast_matches_sed_tpu(sr, impl, sed_tpu_call):
    """n_fft 128 (125 Hz) and 1024 (1 kHz) at fast, where on the card the
    tier GEMMs run: the tick's ``logmel_frames`` on int16 rows, 'roll' and
    'pack', each against sed_tpu's same call at fast, within 1e-3 dB; K1t's
    power at 125 Hz within 2e-5 x the frame's peak and 1e-3 x each bin's
    power, its log-mel within 1e-3 dB of the TPU's rounding emulated in
    float64 (see the module note)."""
    cfg = configs(sr)[0]
    assert cfg.nfft == (128 if sr == 125 else 1024)
    want = sed_tpu_call(sr, impl, "bf16x3")
    if impl == "power":
        got = kernels.stft_power_from_waveform(torch.from_numpy(signal(sr)), cfg, "roll",
                                               "bf16x3").numpy()
        assert got.shape == want.shape == (1, 3, cfg.nfft // 2 + 1)
        assert (np.abs(got - want) <= SED_TPU_POWER * want.max(-1, keepdims=True)).all()
        assert (np.abs(got - want) <= SED_TPU_BIN * want).all()
        # The log-mel in the fast class of the TPU's rounding: the bf16 chunk
        # products of sed_tpu's two stages with every other step in float64.
        x = torch.from_numpy(signal(sr))
        window = kernels.stft_window(cfg, torch.device("cpu")).double()
        frames = stft_ops.frame_signal(x.double(), cfg.nfft, cfg.hop_size) * window
        fb64 = torch.from_numpy(mel_ops.mel_filterbank(cfg, np.float64))
        emulated = kernels.mel_log_plain(kernels._tier_power_plain(
            frames, cfg.nfft, kernels.tier_passes("bf16x3")), fb64)
        lm = kernels.logmel_waveform(x, cfg, impl="roll", precision="bf16x3").double()
        np.testing.assert_allclose(lm.numpy(), emulated.numpy(), rtol=0, atol=FAST_DB)
        return
    if impl == "tick":
        got = featurizer.logmel_frames(torch.from_numpy(tick_rows(sr)), cfg, "bf16x3").numpy()
    else:
        got = kernels.logmel_waveform(torch.from_numpy(signal(sr)), cfg, impl=impl,
                                      precision="bf16x3").numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=FAST_DB)


@pytest.mark.parametrize("sr, impl", [(97, "roll"), (122, "pack")], ids=str)
def test_sed_tpu_refuses_below_the_tier_kernels_smallest(sr, impl):
    """n_fft 64 at 'roll' and 128 at 'pack' (an even hop, so not the even/odd
    check): sed_tpu's tiles of 128 lanes hold no row of the frame (of its 64
    packed points), so its reshape to them fails, at parity and fast alike;
    the tier kernels' range starts above them."""
    cfg, jcfg = configs(sr)
    assert cfg.nfft == (64 if impl == "roll" else 128) and cfg.hop_size % 2 == 0
    for precision in (None, "bf16x3"):
        # its tile of 128 lanes holds no row of a 64-point frame (64 packed points)
        with pytest.raises(TypeError, match=r"cannot reshape array of shape \(8, 0, 128\)"):
            jax_pallas.logmel_waveform_pallas(jnp.asarray(signal(sr, hops=20)), jcfg, impl=impl,
                                              precision=precision)
    log2_n = cfg.nfft.bit_length() - 1
    name = "wave_dft_power_bf16" if impl == "roll" else "wave_packed_fft_bf16"
    assert log2_n + 1 == kernels.TIER_RANGES[name][0]


def segments_at(n_fft) -> int:
    """The 64-band Slaney bank's segments at a rate whose frame is 3/4 of
    n_fft."""
    cfg = SpectrogramConfig(working_sample_rate=int(0.75 * n_fft / 0.66))
    assert cfg.nfft == n_fft
    return kernels.mel_bands(cfg, torch.device("cpu")).n_segments


@pytest.mark.parametrize("log2_n", range(2, 21))
def test_launch_plan_covers_every_size_within_shared_memory(log2_n):
    """At every power of two 4..2^20: every kernel's plan within 232,448 B
    of dynamic shared memory (the segment sums of the bank at that size);
    the FFT kernels over one launch up to 131072, then the cross pass (and
    K5 a chain); the tier kernels over their range: K6t's instances where
    they reach, the GEMMs (K5t a chain) elsewhere, and at TIER_LOG2_N K1t's,
    K3t's and K5t's route the library's (the fused kernel or the GEMMs,
    sed_tier_fused_plan: None here); every known route's kernels with plans
    of their own, and a multi-launch route counting its kernels, not itself.
    K2's and the tier GEMMs' stages' shared memory is the library's choice
    (None here, read on the card by test_torch_cuda.py), so are the routes'
    that run them."""
    n_fft = 1 << log2_n
    n_seg = segments_at(n_fft) if n_fft >= 64 else 1
    plan = kernels.launch_plan(n_fft, n_seg)
    unknown = {name for name, p in plan.items() if p["smem"] is None}
    library = {"mel_log", "tier_inner", "tier_outer"}
    chosen = {name for name, p in plan.items() if p["route"] is None}
    assert chosen == ({"wave_dft_power_bf16", "frames_dft_power_bf16", "wave_stft_mel_log_bf16"}
                      & set(plan) if log2_n in kernels.TIER_LOG2_N else set())
    assert all(set(plan[name].values()) == {None} for name in chosen)
    assert unknown - chosen == {name for name, p in plan.items()
                                if name not in chosen and library & set(p["kernels"])}
    assert all(p["smem"] <= 232448 for p in plan.values() if p["smem"] is not None)
    for name in ("wave_stft_power", "frames_stft_power", "wave_packed_fft", "wave_stft_mel_log",
                 "mel_log"):
        big = n_fft > kernels.CLUSTER_FFT_MAX and name != "mel_log"
        assert plan[name]["route"] == ("one" if not big else
                                       "chain" if name == "wave_stft_mel_log" else "cross")
    for name, sizes in kernels.TIER_RANGES.items():
        assert (name in plan) == (log2_n in sizes)
        if name in plan:
            inst = kernels.PACKED_TIER_LOG2_N if "packed" in name else kernels.TIER_LOG2_N
            route = plan[name]["route"]
            assert route == (("one" if "packed" in name else None) if log2_n in inst else
                             "chain" if name == "wave_stft_mel_log_bf16" else "gemm")
    for name, p in plan.items():
        if name in chosen:
            continue
        assert all(k in plan and plan[k]["route"] == "one" for k in p["kernels"])
        assert (p["kernels"] == (name,)) == (p["route"] == "one")


def test_launch_plan_refuses_above_2_20_as_the_wrappers_do():
    """Above n_fft 2^20 (1.536 MHz) launch_plan raises the ValueError the
    wrappers raise, naming the limit; the tier kernels name their range."""
    with pytest.raises(ValueError, match="exceeds 1048576") as plan_error:
        kernels.launch_plan(1 << 21)
    window = torch.zeros(1 << 21)
    with pytest.raises(ValueError) as wrapper_error:
        kernels._check_fft_size(1 << 21, window)
    assert str(plan_error.value) == str(wrapper_error.value)
    for name in kernels.TIER_RANGES:
        with pytest.raises(ValueError, match="to 1048576"):
            kernels.tier_route(name, 1 << 21)
    kernels.launch_plan(1 << 20)
