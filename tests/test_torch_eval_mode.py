"""The scoring functions run their model in eval mode on every call, and every
entry point runs in full float32 for its call only (CPU).

Eval mode: the batch predictor, the batch evaluator and the stream
functions, built from a model that is then put in training mode (as every
train step leaves it), score exactly as in eval mode, leave the running
BatchNorm statistics as they were, and a train step still runs after them.
Precision: during each call both TF32 flags (cuDNN's and matmul's) read
False, and after it they read the caller's values.
"""

import copy

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from sed_tpu_torch import streaming
from sed_tpu_torch.cli import infer
from sed_tpu_torch.configs import SpectrogramConfig, WaveformConfig
from sed_tpu_torch.data import device_pipeline as pipe
from sed_tpu_torch.inference import make_batch_evaluator, make_batch_predictor
from sed_tpu_torch.models.cnn import CnnAvgPooling, MobileNetV1
from sed_tpu_torch.models.m5 import M5
from sed_tpu_torch.train import loop
from sed_tpu_torch.train.state import init_state, make_eval_forward, make_train_step
from sed_tpu_torch.utils.precision import full_float32

CFG = SpectrogramConfig(working_sample_rate=8000, time_margin=0.33)
WCFG = WaveformConfig(working_sample_rate=8000, time_margin=0.33)
SMALL = ((8, 2), (16, 2))


@pytest.fixture(autouse=True)
def _one_thread_and_flags():
    n = torch.get_num_threads()
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def tf32_flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def set_tf32(on: bool):
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def seeded(model, seed=0):
    """Non-trivial BatchNorm statistics, so eval mode and train mode differ."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.uniform_(-0.5, 0.5, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
    return model


def make_model(arch):
    if arch == "CnnAvgPooling":
        return seeded(CnnAvgPooling(1, SMALL, generator=torch.Generator().manual_seed(1)))
    if arch == "MobileNetV1":
        return seeded(MobileNetV1(1, emit="logits", generator=torch.Generator().manual_seed(1)))
    return seeded(M5(1, generator=torch.Generator().manual_seed(1)))


def waves(batch=2, seconds=6, seed=0):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((batch, seconds * CFG.working_sample_rate, 1))
            ).astype(np.float32)


def statistics(model):
    return {k: v.clone() for k, v in model.state_dict().items() if "running" in k}


def train_step_runs(model):
    """One training step on ready batches after the scoring calls: it would
    raise if a call had left an inference tensor in a BatchNorm buffer."""
    state = init_state(model, 1e-3, "cpu")
    x = torch.randn(2, 1, 24, CFG.mel_bins, generator=torch.Generator().manual_seed(3))
    loss = make_train_step()(state, x, torch.zeros(2, 24, 1))
    assert torch.isfinite(loss) and state.step == 1


# ---------------------------------------------------------------------------
# Eval mode on every call
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["CnnAvgPooling", "MobileNetV1"])
def test_batch_predictor_scores_in_eval_mode_after_train(arch):
    model = make_model(arch)
    predict = make_batch_predictor(model, CFG, device="cpu")
    x = waves()
    before = predict(x)
    stats = statistics(model)
    model.train()
    after = predict(x)
    assert torch.equal(after, before)
    for k, v in statistics(model).items():
        assert torch.equal(v, stats[k]), k
    train_step_runs(model)


@pytest.mark.parametrize("arch", ["CnnAvgPooling", "MobileNetV1"])
def test_batch_evaluator_scores_in_eval_mode_after_train(arch):
    model = make_model(arch)
    evaluate = make_batch_evaluator(model, CFG, device="cpu")
    x = waves()
    targets = np.zeros((2, 16, 1), np.float32)
    targets[:, 4:8] = 1
    before = evaluate(x, targets)
    stats = statistics(model)
    model.train()
    after = evaluate(x, targets)
    for a, b in zip(after, before):
        assert torch.equal(a, b)
    for k, v in statistics(model).items():
        assert torch.equal(v, stats[k]), k
    train_step_runs(model)


def test_stream_functions_score_in_eval_mode_after_train():
    model = make_model("CnnAvgPooling")
    featurize, forward = streaming.make_stream_fns(model, CFG, device="cpu")
    rng = np.random.default_rng(4)
    frames = (0.1 * rng.standard_normal((40, CFG.nfft))).astype(np.float32)
    x = featurize(frames)[None, None]
    before = forward(x)
    stats = statistics(model)
    model.train()
    assert torch.equal(forward(x), before)
    for k, v in statistics(model).items():
        assert torch.equal(v, stats[k]), k
    train_step_runs(model)


def test_streaming_detector_after_train_scores_as_before():
    """The detector's scores go through the stream functions: a model put in
    training mode between two detectors changes nothing."""
    model = make_model("CnnAvgPooling")
    audio = waves(1, 8)[0, :, 0]
    first = streaming.StreamingDetector(model, CFG, total_stride=4, device="cpu")
    a = np.concatenate([first.push(audio), first.flush()])
    model.train()
    second = streaming.StreamingDetector(model, CFG, total_stride=4, device="cpu")
    b = np.concatenate([second.push(audio), second.flush()])
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Full float32 for the call only
# ---------------------------------------------------------------------------

def test_full_float32_restores_the_flags_also_on_error():
    for on in (True, False):
        set_tf32(on)
        with full_float32():
            assert tf32_flags() == (False, False)
        assert tf32_flags() == (on, on)
    set_tf32(True)
    with pytest.raises(RuntimeError):
        with full_float32():
            raise RuntimeError("boom")
    assert tf32_flags() == (True, True)


def _spectrogram_store():
    class Store:
        rng = np.random.default_rng(5)
        train_features = rng.standard_normal((1, 200, CFG.mel_bins)).astype(np.float32)
        train_event_matrix = (rng.random((200, 1)) > 0.7).astype(np.float32)
        train_start_indices = rng.permutation(200 - CFG.train_crop_size).astype(np.int32)
        mean = train_features.mean(axis=(0, 1))
        std = train_features.std(axis=(0, 1))

        def __len__(self):
            return len(self.train_start_indices)

        def epoch_start_indices(self, batch_size, drop_last=True):
            for i in range(0, len(self) - len(self) % batch_size, batch_size):
                yield self.train_start_indices[i:i + batch_size]

        def get_validation_sampler(self, max_validate_num=None):
            yield self.train_features[None, :, :40], self.train_event_matrix[None, :40], "v"

    return Store()


def _waveform_store():
    class Store:
        rng = np.random.default_rng(6)
        long_waveform = (0.1 * rng.standard_normal((1, 3 * WCFG.frame_size))).astype(np.float32)
        all_start_indices_labels = rng.random(3 * WCFG.frame_size) > 0.8
        possible_start_indices = np.arange(2 * WCFG.frame_size, dtype=np.int32)

    return Store()


def _wav(tmp_path):
    path = str(tmp_path / "a.wav")
    wavfile.write(path, 48000, (0.1 * np.random.default_rng(7).standard_normal(3 * 48000)
                                ).astype(np.float32))
    return path


def _call(entry, tmp_path):
    """Build ``entry`` with a model and call it once; returns the model."""
    if entry == "predictor":
        model = make_model("CnnAvgPooling")
        make_batch_predictor(model, CFG, device="cpu")(waves())
    elif entry == "evaluator":
        model = make_model("CnnAvgPooling")
        make_batch_evaluator(model, CFG, device="cpu")(waves(), np.zeros((2, 16, 1)))
    elif entry == "stream_functions":
        model = make_model("CnnAvgPooling")
        featurize, forward = streaming.make_stream_fns(model, CFG, device="cpu")
        frames = np.zeros((40, CFG.nfft), np.float32)
        forward(featurize(frames)[None, None])
    elif entry == "eval_forward":
        model = make_model("CnnAvgPooling")
        make_eval_forward(model)(torch.zeros(1, 1, 24, CFG.mel_bins))
    elif entry == "train_step":
        model = make_model("CnnAvgPooling")
        make_train_step()(init_state(model, 1e-3, "cpu"), torch.zeros(2, 1, 24, CFG.mel_bins),
                          torch.zeros(2, 24, 1))
    elif entry in ("spectrogram_step", "multi_step"):
        store = _spectrogram_store()
        model = make_model("CnnAvgPooling")
        step = pipe.make_spectrogram_train_step(CFG, augment=True)
        bufs = pipe.spectrogram_buffers_from_dataset(store, "cpu")
        state, gen = init_state(model, 1e-3, "cpu"), torch.Generator().manual_seed(0)
        if entry == "multi_step":
            pipe.make_multi_step(step, 2)(state, bufs, np.stack(
                [store.train_start_indices[:4], store.train_start_indices[4:8]]), gen)
        else:
            step(state, bufs, store.train_start_indices[:4], gen)
    elif entry == "waveform_step":
        store = _waveform_store()
        model = make_model("M5")
        pipe.make_waveform_train_step(WCFG, augment=True)(
            init_state(model, 1e-3, "cpu"), pipe.waveform_buffers_from_dataset(store, "cpu"),
            store.possible_start_indices[:4], torch.Generator().manual_seed(0))
    elif entry == "train":
        model = make_model("CnnAvgPooling")
        loop.train(model, _spectrogram_store(), "spectogram", 2, 1e-3, 2,
                   str(tmp_path / "out"), batch_size=4, cfg=CFG, make_plots=False,
                   initial_state=init_state(model, 1e-3, "cpu"), device="cpu")
    elif entry == "predict_file":
        model = make_model("CnnAvgPooling")
        infer.predict_file(model, _wav(tmp_path), SpectrogramConfig(), device="cpu")
    elif entry == "predict_file_m5":
        model = make_model("M5")
        infer.predict_file_m5(model, _wav(tmp_path), WaveformConfig(), device="cpu")
    return model


ENTRIES = ["predictor", "evaluator", "stream_functions", "eval_forward", "train_step",
           "spectrogram_step", "multi_step", "waveform_step", "train", "predict_file",
           "predict_file_m5"]


@pytest.mark.parametrize("caller", [True, False], ids=["tf32_on", "tf32_off"])
@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_points_run_in_full_float32_for_the_call(tmp_path, monkeypatch, entry, caller):
    seen = []
    real_call = torch.nn.Module.__call__

    def hooked(self, *args, **kwargs):
        if not list(self.children()):   # a leaf layer: the work itself
            seen.append(tf32_flags())
        return real_call(self, *args, **kwargs)

    monkeypatch.setattr(torch.nn.Module, "__call__", hooked)
    real_frames = streaming.logmel_frames
    monkeypatch.setattr(streaming, "logmel_frames",
                        lambda *a, **k: seen.append(tf32_flags()) or real_frames(*a, **k))
    set_tf32(caller)
    _call(entry, tmp_path)
    assert seen and set(seen) == {(False, False)}
    assert tf32_flags() == (caller, caller)


def test_building_changes_no_flag():
    set_tf32(True)
    model = make_model("CnnAvgPooling")
    make_batch_predictor(copy.deepcopy(model), CFG, device="cpu")
    make_batch_evaluator(copy.deepcopy(model), CFG, device="cpu")
    streaming.make_stream_fns(copy.deepcopy(model), CFG, device="cpu")
    pipe.make_spectrogram_train_step(CFG)
    pipe.make_waveform_train_step(WCFG)
    make_train_step()
    assert tf32_flags() == (True, True)
