"""int8 x int8 -> int32 products for the int8 serving path (port-only; the
products of ``sed_tpu.models.quantize``).

``sed_tpu`` contracts int8 activations against int8 weights into int32
with ``lax.conv_general_dilated`` / ``dot_general`` and
``preferred_element_type=int32``.  Eager PyTorch on CUDA has no int8
convolution, but it has ``torch._int_mm`` (cuBLASLt's int8 GEMM, exact), so
each convolution here is an im2col gather in int8 followed by one matrix
product:

  * :func:`int8_matmul` — ``torch._int_mm`` for a CUDA tensor; for a CPU
    tensor the plain version, a float64 product of the int8 values (exact:
    ``|acc| <= 127**2 * K`` stays far below 2**53 for every K here); any
    other device raises.  ``_int_mm`` wants more than 16 rows and K and N
    multiples of 8: the operands are padded with zero rows and columns,
    which leaves the int32 result exact, and the result is sliced back.
    The second operand goes to ``_int_mm`` column-major (both operands
    K-major), the one layout of cuBLASLt's int8 tensor-core (IMMA) kernels;
    row-major, the card raised CUBLAS_STATUS_NOT_SUPPORTED for K of 16 to
    96 against N = 64.
  * :func:`int8_conv2d_nhwc` — a 3x3 (any odd square kernel) stride-1
    convolution with ``pad`` zeros on each side; the shifted slices of the
    zero-padded NHWC tensor are stacked tap-major, (N*H*W, kh*kw*Cin), to
    match the OIHW weight reshaped to (kh*kw*Cin, Cout).  A 1x1 kernel
    with no padding is a plain reshape.
  * :func:`int8_conv1d_nwc` — a strided 1-D convolution of an NWC tensor
    by the same gather: k shifted strided slices.

``LAUNCHES["int_mm"]`` counts the ``_int_mm`` launches, as
``cuda_featurizer.LAUNCHES`` counts the featurizer kernels' (the plain
version counts nothing).
"""

from __future__ import annotations

import torch

LAUNCHES = {"int_mm": 0}

# torch._int_mm's shape rules on CUDA: rows > MIN_ROWS, K and N multiples
# of ALIGN.
MIN_ROWS = 16
ALIGN = 8


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def int8_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32 through float64 (exact)."""
    return (a.double() @ b.double()).to(torch.int32)


def _padded(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``x`` in the top-left corner of a contiguous zero (rows, cols) tensor
    (``x`` itself, made contiguous, when it already has that shape)."""
    if tuple(x.shape) == (rows, cols):
        return x.contiguous()
    out = x.new_zeros((rows, cols))
    out[: x.shape[0], : x.shape[1]] = x
    return out


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact.

    A CPU tensor takes :func:`int8_matmul_plain`; a CUDA tensor launches
    ``torch._int_mm`` on operands padded to its shape rules; any other
    device raises."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_matmul needs int8 operands, got {a.dtype} and {b.dtype}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"int8_matmul: shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"int8_matmul: operands on {a.device} and {b.device}")
    if a.device.type == "cpu":
        return int8_matmul_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {a.device}")
    if a.shape[0] == 0 or b.shape[1] == 0:
        return torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int32, device=a.device)
    out = int_mm_padded(a, b)
    LAUNCHES["int_mm"] += 1
    return out


def int_mm_padded(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm`` of (M, K) and (K, N) int8 operands padded with zero
    rows and columns to its shape rules on CUDA (rows > 16, K and N
    multiples of 8), ``b`` passed column-major, the (M, N) int32 result
    sliced back: exact, since the padding adds only zero products.  A ``b``
    that is the transpose of a contiguous (N, K) weight needs no copy."""
    m, k = a.shape
    n = b.shape[1]
    rows = max(m, MIN_ROWS + 1)
    kp = ALIGN * -(-k // ALIGN)
    np_ = ALIGN * -(-n // ALIGN)
    out = torch._int_mm(_padded(a, rows, kp), _padded(b.t(), np_, kp).t())
    return out if (rows, np_) == (m, n) else out[:m, :n]


def int8_conv2d_nhwc(x_q: torch.Tensor, w_q: torch.Tensor, pad: int) -> torch.Tensor:
    """Stride-1 convolution of an (N, H, W, Cin) int8 tensor by an OIHW
    (Cout, Cin, k, k) int8 weight with ``pad`` zeros on each side ->
    (N, H + 2 * pad - k + 1, W + 2 * pad - k + 1, Cout) int32."""
    n, h, w, cin = x_q.shape
    cout, wcin, kh, kw = w_q.shape
    if wcin != cin:
        raise ValueError(f"int8_conv2d_nhwc: input has {cin} channels, weight {wcin}")
    if pad:
        xp = x_q.new_zeros((n, h + 2 * pad, w + 2 * pad, cin))
        xp[:, pad:pad + h, pad:pad + w] = x_q
    else:
        xp = x_q
    ho, wo = h + 2 * pad - kh + 1, w + 2 * pad - kw + 1
    if kh == kw == 1:
        cols = xp.reshape(n * ho * wo, cin)
    else:
        cols = torch.stack([xp[:, dy:dy + ho, dx:dx + wo] for dy in range(kh)
                            for dx in range(kw)], dim=3).reshape(n * ho * wo, kh * kw * cin)
    # (Cout, kh * kw * Cin), tap-major as the columns; passed transposed.
    w_mat = w_q.permute(0, 2, 3, 1).reshape(cout, kh * kw * cin)
    return int8_matmul(cols, w_mat.t()).reshape(n, ho, wo, cout)


def int8_conv1d_nwc(x_q: torch.Tensor, w_q: torch.Tensor, stride: int, pad: int) -> torch.Tensor:
    """Convolution of an (N, T, Cin) int8 tensor by an (Cout, Cin, k) int8
    weight at ``stride`` with ``pad`` zeros on each side ->
    (N, (T + 2 * pad - k) // stride + 1, Cout) int32."""
    n, t, cin = x_q.shape
    cout, wcin, k = w_q.shape
    if wcin != cin:
        raise ValueError(f"int8_conv1d_nwc: input has {cin} channels, weight {wcin}")
    if pad:
        xp = x_q.new_zeros((n, t + 2 * pad, cin))
        xp[:, pad:pad + t] = x_q
    else:
        xp = x_q
    t_out = (t + 2 * pad - k) // stride + 1
    span = stride * (t_out - 1) + 1
    if k == 1:
        cols = xp[:, :span:stride].reshape(n * t_out, cin)
    else:
        cols = torch.stack([xp[:, j:j + span:stride] for j in range(k)],
                           dim=2).reshape(n * t_out, k * cin)
    w_mat = w_q.permute(0, 2, 1).reshape(cout, k * cin)
    return int8_matmul(cols, w_mat.t()).reshape(n, t_out, cout)
