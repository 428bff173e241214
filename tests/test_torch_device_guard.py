"""The kernels' C entry points leave the caller's CUDA device as they found it.

Each ``extern "C"`` entry point of ``sed_tpu_torch/ops/csrc/featurizer.cu``
that launches a kernel makes its tensor's device current through
``DeviceGuard``, whose destructor restores the caller's device on every
return path.  There is no card here, so these tests read the source: every
launching entry point takes a device and starts with the guard, and no
``cudaSetDevice`` is called outside the guard.  ``tests/test_torch_cuda.py``
checks the behaviour on a machine with two cards.
"""

import re

import pytest

from sed_tpu_torch.ops import cuda_featurizer as kernels

ENTRY_POINTS = ("sed_wave_stft_power", "sed_frames_stft_power", "sed_mel_log",
                "sed_wave_stft_mel_log", "sed_wave_packed_fft", "sed_tier_dft_power",
                "sed_tier_packed_fft", "sed_fft_cross_pass", "sed_fft_subrows",
                "sed_packed_power", "sed_tier_split", "sed_tier_inner", "sed_tier_outer")
GUARD = ("const DeviceGuard guard(device);",
         "if (guard.status() != cudaSuccess) return guard.status();")


def source() -> str:
    return kernels.SOURCE.read_text()


def extern_c_functions() -> dict:
    """{name: (parameters, body lines)} of the functions in the extern "C" block."""
    src = source()
    block = src[src.index('extern "C" {'):src.index('}  // extern "C"')]
    found = re.findall(r"^[\w* ]+?\b(\w+)\(([^)]*)\) \{\n(.*?)^\}", block, re.M | re.S)
    return {name: (params, [ln.strip() for ln in body.splitlines() if ln.strip()])
            for name, params, body in found}


def launches(body) -> bool:
    text = "\n".join(body)
    return "<<<" in text or "kLaunch" in text or "launch_" in text


def test_the_launching_entry_points_are_the_five_wrapped_ones():
    functions = extern_c_functions()
    assert {n for n, (_, body) in functions.items() if launches(body)} == set(ENTRY_POINTS)
    # beside them, four that launch nothing: the error string, K2's plan, the
    # tier GEMMs' plan and the fused tier route's plan
    assert set(functions) == set(ENTRY_POINTS) | {"sed_error_string", "sed_mel_plan",
                                                  "sed_tier_gemm_plan", "sed_tier_fused_plan"}


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_starts_with_the_device_guard(name):
    params, body = extern_c_functions()[name]
    assert re.search(r"\bint device\b", params)
    assert tuple(body[:2]) == GUARD
    assert not any("cudaSetDevice" in line for line in body)


def test_no_cudaSetDevice_outside_the_guard_which_restores_the_callers_device():
    src = source()
    start = src.index("class DeviceGuard {")
    end = src.index("};", start)
    guard = src[start:end]
    assert src.count("cudaSetDevice(") == guard.count("cudaSetDevice(") == 2
    # It switches only when the device differs, and switches back when it did.
    assert "caller_ != device" in guard
    destructor = guard[guard.index("~DeviceGuard()"):]
    assert "if (switched_) cudaSetDevice(caller_);" in destructor
