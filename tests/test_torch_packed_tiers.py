"""A numpy model of K6t, the wgmma packed DFT (``tier_packed_fft_kernel`` in
``sed_tpu_torch/ops/csrc/featurizer.cu``), held against its plain version.

The kernel reads its W2 and W1 operands from host-made images of its
shared-memory tiles (``cuda_featurizer._packed_tables``: the bf16 chunks of
``packed_operands``' A1 and A2, K-major tiles of 64 columns under the
128-byte swizzle, each 64-row tile's chunks one bulk copy, laid out
alike whatever k2 rows a unit the instance takes), splits the frame's points
into X tiles of the same layout, keeps T^T (kb rows k2, [Tr | Ti] over b)
between its two stages and drains rows of kb bins k2.  The model below
reads the images back through the swizzle as wgmma's descriptors address
them, multiplies tile by tile over the kernel's terms (float64 sums), rounds
the twiddle in float32 as the kernel does and writes each bin where the
drain writes it; the result must equal the plain version
(``wave_packed_fft_bf16_plain``'s ``_tier_packed_plain``) to the float32
rounding of the sums, at every n1 and at pass counts that take every shape
``packed_plan`` picks.
"""

import numpy as np
import pytest
import torch

from sed_tpu_torch.ops import cuda_featurizer as kernels
from sed_tpu_torch.ops import stft as stft_ops

CPU = torch.device("cpu")
TERMS = {p: [(a, b) for a, b in ((0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (0, 2))[:p]]
         for p in (1, 3, 4, 6)}


def unswizzle(img):
    """Logical (..., rows, 64) of a tile image: element (r, c) as the 128-byte
    swizzle places it."""
    r = np.arange(img.shape[-2])[:, None]
    c = np.arange(64)[None, :]
    return img[..., r, ((c >> 3) ^ (r & 7)) << 3 | (c & 7)]


def chunks(a, n):
    return [c.numpy().astype(np.float64)
            for c in kernels.split_bf16(torch.from_numpy(np.asarray(a, np.float32)), n)]


def packed_model(z, passes):
    """K6t on one frame's m windowed packed points ``z`` (complex, float32
    parts); returns Z (m,) complex in natural bin order."""
    m = len(z)
    inner, outer = passes
    c1, c2 = kernels._tier_chunks(inner), kernels._tier_chunks(outer)
    n1, n2, _, _, tw = kernels.packed_operands(m)
    plan = kernels.packed_plan(n1, inner, outer)
    kb, n1p = plan["kb"], plan["n1p"]
    tab1, tab2, _ = kernels._packed_tables(m, c1, c2, CPU)
    t1 = unswizzle(tab1.float().numpy().reshape(n2 // 32, n2 // 32, c1, 64, 64))
    kt2n = 2 * n1 // 64
    t2 = unswizzle(tab2.float().numpy().reshape(kt2n, kt2n, c2, 64, 64))
    zr, zi = z.real.astype(np.float32), z.imag.astype(np.float32)
    out = np.full(m, np.nan, dtype=np.complex128)
    rows = np.arange(64)
    k_of_row = 8 * (rows // 16) + rows % 8          # k2 (k1) of an M tile's row
    imag_row = rows // 8 % 2 == 1
    for blk in range(n2 // kb):
        k0 = kb * blk
        tt = np.zeros((c2, kt2n, kb, 64))           # T^T: chunk, K tile, row k2, column
        for h in range(n1 // n1p):
            acc = np.zeros((kb // 32, 64, n1p))
            b = h * n1p + np.arange(n1p)
            for kt in range(n2 // 32):
                a = 32 * kt + np.arange(32)
                idx = a[None, :] * n1 + b[:, None]   # X tile row b, column a (Re, then Im)
                x = [np.concatenate([cr, ci], axis=1)
                     for cr, ci in zip(chunks(zr[idx], c1), chunks(zi[idx], c1))]
                for ca, cb in TERMS[inner]:
                    for mt in range(kb // 32):
                        acc[mt] += t1[blk * (kb // 32) + mt, kt, ca] @ x[cb].T
            for mt in range(kb // 32):
                k2l = 32 * mt + k_of_row[~imag_row]
                yr = acc[mt][~imag_row].astype(np.float32)
                yi = acc[mt][imag_row].astype(np.float32)
                twr = tw[k0 + k2l[:, None], b[None, :], 0]
                twi = tw[k0 + k2l[:, None], b[None, :], 1]
                tr = yr * twr - yi * twi                 # float32, no fused multiply-add
                ti = yr * twi + yi * twr
                for c, (cr, ci) in enumerate(zip(chunks(tr, c2), chunks(ti, c2))):
                    for col, v in ((b, cr), (n1 + b, ci)):
                        tt[c, col // 64, k2l[:, None], col % 64] = v
        for mt2 in range(kt2n):
            acc2 = np.zeros((64, kb))
            for kt2 in range(kt2n):
                for ca, cb in TERMS[outer]:
                    acc2 += t2[mt2, kt2, ca] @ tt[cb, kt2].T
            k1 = 32 * mt2 + k_of_row[~imag_row]
            bins = k1[:, None] * n2 + k0 + np.arange(kb)[None, :]
            out[bins] = (acc2[~imag_row].astype(np.float32)
                         + 1j * acc2[imag_row].astype(np.float32))
    return out


CASES = [(4096, "bf16x3"), (4096, ("bf16x6", "bf16x1")), (8192, "bf16x1"),
         (8192, ("bf16x4", "bf16x6")), (16384, "bf16x3"), (32768, "bf16x3"),
         (32768, "bf16x6"), (65536, ("bf16x1", "bf16x3")), (65536, "bf16x6"),
         (131072, "bf16x1"), (131072, ("bf16x6", "bf16x4"))]


@pytest.mark.parametrize("n_fft, precision", CASES, ids=str)
def test_model_of_k6t_matches_the_plain_version(n_fft, precision):
    """Every bin written once, within 2e-6 x the frame's peak |Z| of the
    plain version (the model sums each tile in float64 where the kernel and
    the plain version round elsewhere in float32); where the outer stage is
    bf16x1, an ulp of difference in the twiddled T flips its one bf16
    rounding: 1.5e-3 there (the gpu tests' tier_tol)."""
    m = n_fft // 2
    passes = kernels.tier_passes(precision)
    rng = np.random.default_rng(n_fft)
    x = rng.standard_normal(n_fft).astype(np.float32)
    got = packed_model(x[0::2] + 1j * x[1::2], passes)
    wr, wi = kernels._tier_packed_plain(torch.from_numpy(x)[None], n_fft, passes)
    want = wr[0].double().numpy() + 1j * wi[0].double().numpy()
    assert not np.isnan(got).any()
    tol = 1.5e-3 if passes[1] == 1 else 2e-6
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_packed_plans_fit_and_their_images_are_bulk_copy_sized():
    """Every instance's shape fits 227 KB; a stage-1 slot's X tiles, each of
    its kb / 32 bulk copies of W2 (a 64-row tile's C1 chunks, at the copy's
    offset in tab1's image) and a stage-2 slot's W1 tiles are whole numbers
    of 16 bytes, each tile 1024-byte sized (the swizzle's period)."""
    for n1 in (32, 64, 128, 256):
        for p1 in (1, 3, 4, 6):
            for p2 in (1, 3, 4, 6):
                plan = kernels.packed_plan(n1, p1, p2)
                assert plan["smem"] <= 232448
                assert plan["kb"] in (32, 64) and n1 % plan["n1p"] == 0
                assert (plan["n1p"] * 128) % 1024 == 0
                c1 = kernels._tier_chunks(p1)
                for m in {n1 * n1, 2 * n1 * n1} & {2 ** k for k in range(11, 17)}:
                    tab1, _, _ = kernels._packed_tables(m, c1, kernels._tier_chunks(p2), CPU)
                    n2 = m // n1
                    copy = c1 * 64 * 64                   # bf16 of one bulk copy
                    assert tab1.numel() == (n2 // 32) * (n2 // 32) * copy
                    assert (2 * copy) % 1024 == 0 and plan["kb"] % 32 == 0


# ---------------------------------------------------------------------------
# The tier GEMMs (tier_inner_kernel, tier_outer_kernel): K1t and K3t at n_fft
# 128..1024 and 2^18..2^20, K6t at 256..2048 and 2^18..2^20, each stage a
# GEMM of 64 x 64 blocks over every frame at once through device memory.
# The model reads the host's tables as the kernels do, multiplies over the
# tier's terms (float64 sums, rounded to float32), and runs each block's
# epilogue at the fragment positions of mma.m16n8k16 (lane l: group g = l /
# 4, column pair 2 (l mod 4)); every T entry and every output bin must be
# written once, and the result equal the plain version to the float32
# rounding of the sums.
# ---------------------------------------------------------------------------

GEMM_TILE = 64
_W, _I, _J, _L = np.meshgrid(range(4), range(2), range(4), range(32), indexing="ij")
FRAG_ROW = (_W >> 1) * 32 + _I * 16          # the 16-row group of a fragment
FRAG_G = _L >> 2
FRAG_COL = (_W & 1) * 32 + _J * 8 + 2 * (_L & 3)


def f32(a):
    return np.asarray(a, np.float32)


def tier_inner_model(x, n, inner, packed):
    """tier_inner_kernel on ``rows`` frames of windowed samples (real, (rows,
    n)) or packed points (complex, (rows, n)); returns T (rows, n2, n1)
    complex (float32 parts)."""
    rows = x.shape[0]
    log2_n1, log2_n2 = kernels._gemm_dims(n)
    n1, n2 = 1 << log2_n1, 1 << log2_n2
    c1 = kernels._tier_chunks(inner)
    tables = kernels._packed_gemm_tables if packed else kernels._tier_tables
    tab1, _, tw = tables(n, c1, 1, CPU)
    tab1, tw = tab1.float().numpy().astype(np.float64), tw.numpy()
    if packed:
        xs = np.concatenate([x.real.reshape(rows, n2, n1), x.imag.reshape(rows, n2, n1)], axis=1)
    else:
        xs = x.reshape(rows, n2, n1)
    k_len = xs.shape[1]
    assert tab1.shape == (c1, 2 * n2, k_len)
    b = xs.transpose(1, 0, 2).reshape(k_len, rows * n1)   # column f n1 + b
    bc = chunks(b, c1)
    acc = f32(sum(tab1[ca] @ bc[cb] for ca, cb in TERMS[inner]))
    n_rows, n_cols = 2 * n2, rows * n1
    t = np.full((rows, n2, n1), np.nan, np.complex128)
    written = np.zeros((rows, n2, n1), int)
    row_blocks = -(-n_rows // GEMM_TILE)
    for block in range(row_blocks * -(-n_cols // GEMM_TILE)):
        r0, c0 = block % row_blocks * GEMM_TILE, block // row_blocks * GEMM_TILE
        row, col = r0 + FRAG_ROW, c0 + FRAG_COL
        keep = (row < n_rows) & (col < n_cols)
        row, col, g = row[keep], col[keep], FRAG_G[keep]
        k2 = row // 2 + g
        f, bb = col >> log2_n1, col & (n1 - 1)
        for h in (0, 1):   # columns b, b + 1
            yr, yi = acc[row + g, col + h], acc[row + g + 8, col + h]
            twr, twi = tw[k2, bb + h, 0], tw[k2, bb + h, 1]
            tr = f32(f32(yr * twr) - f32(yi * twi))
            ti = f32(f32(yr * twi) + f32(yi * twr))
            t[f, k2, bb + h] = tr + 1j * ti.astype(np.float64)
            np.add.at(written, (f, k2, bb + h), 1)
    assert (written == 1).all()
    return t


def tier_outer_model(t, n, outer, packed):
    """tier_outer_kernel on T: (rows, n/2 + 1) power (K1t, K3t) or (rows, n)
    complex Z (K6t), natural bin order."""
    rows, n2, n1 = t.shape
    log2_n2 = n2.bit_length() - 1
    c2 = kernels._tier_chunks(outer)
    tables = kernels._packed_gemm_tables if packed else kernels._tier_tables
    _, tab2, _ = tables(n, 1, c2, CPU)
    tab2 = tab2.float().numpy().astype(np.float64)
    n_cols = 2 * n1 if packed else n1 + 8
    assert tab2.shape == (c2, n_cols, 2 * n1)
    a = np.concatenate([t.real, t.imag], axis=-1).reshape(rows * n2, 2 * n1)
    ac = chunks(a, c2)
    acc = f32(sum(ac[ca] @ tab2[cb].T for ca, cb in TERMS[outer]))
    n_rows = rows * n2
    out = np.full((rows, n if packed else n // 2 + 1), np.nan,
                  np.complex128 if packed else np.float64)
    written = np.zeros(out.shape, int)
    col_blocks = -(-n_cols // GEMM_TILE)
    for block in range(-(-n_rows // GEMM_TILE) * col_blocks):
        r0, c0 = block // col_blocks * GEMM_TILE, block % col_blocks * GEMM_TILE
        for h in (0, 1):   # the fragment's rows g and g + 8
            row, col = r0 + FRAG_ROW + FRAG_G + 8 * h, c0 + FRAG_COL
            keep = (row < n_rows) & (col < n_cols)
            row, col = row[keep], col[keep]
            zr, zi = acc[row, col], acc[row, col + 1]
            f, k2, k1 = row >> log2_n2, row & (n2 - 1), col // 2
            if packed:
                sel = k1 < n1
                idx = (f[sel], n2 * k1[sel] + k2[sel])
                out[idx] = zr[sel] + 1j * zi[sel].astype(np.float64)
            else:
                sel = (k1 < n1 // 2) | ((k1 == n1 // 2) & (k2 == 0))
                idx = (f[sel], n2 * k1[sel] + k2[sel])
                out[idx] = f32(f32(zr[sel] * zr[sel]) + f32(zi[sel] * zi[sel]))
            np.add.at(written, idx, 1)
    assert (written == 1).all()
    return out


GEMM_CASES = [(128, "bf16x3", False), (128, "bf16x1", False), (256, ("bf16x6", "bf16x4"), False),
              (512, "bf16x6", False), (1024, "bf16x3", False), (262144, "bf16x3", False),
              (1048576, "bf16x1", False), (256, "bf16x3", True), (512, ("bf16x1", "bf16x6"), True),
              (1024, "bf16x4", True), (2048, "bf16x3", True), (262144, "bf16x6", True),
              (1048576, "bf16x3", True)]


@pytest.mark.parametrize("n_fft, precision, packed", GEMM_CASES, ids=str)
def test_model_of_the_tier_gemms_matches_the_plain_version(n_fft, precision, packed):
    """K1t's power (``_tier_power_plain``) or K6t's Z (``_tier_packed_plain``)
    of 3 frames through both stages' blocks: n1 = 8 (half of stage 1's k
    tile, a quarter of a block's rows) up to n1 = 1024, n2 = 1024; within
    5e-6 x the frame's peak (2.0e-6 at most here: an ulp of T flips a bf16
    rounding of its low chunk), 1.5e-3 where the outer stage is bf16x1 (its
    one rounding)."""
    passes = kernels.tier_passes(precision)
    x = np.random.default_rng(n_fft).standard_normal((3, n_fft)).astype(np.float32)
    if packed:
        z = x[:, 0::2] + 1j * x[:, 1::2]
        got = tier_outer_model(tier_inner_model(z, n_fft // 2, passes[0], True), n_fft // 2,
                               passes[1], True)
        wr, wi = kernels._tier_packed_plain(torch.from_numpy(x), n_fft, passes)
        want = wr.double().numpy() + 1j * wi.double().numpy()
    else:
        got = tier_outer_model(tier_inner_model(x, n_fft, passes[0], False), n_fft, passes[1],
                               False)
        want = kernels._tier_power_plain(torch.from_numpy(x), n_fft, passes).double().numpy()
    assert got.shape == want.shape
    tol = 1.5e-3 if passes[1] == 1 else 5e-6
    peak = np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(got - want) <= tol * peak).all()


@pytest.mark.parametrize("log2_n", [7, 8, 9, 10, 11, 18, 19, 20])
def test_gemm_plans_follow_sed_tpus_factorisation(log2_n):
    """Where the tier GEMMs run (launch_plan's route 'gemm', K5t's 'chain'),
    their two stages are entries of their own, with static shared memory
    only (the compiler bounds it; their C entries refuse a grid past 2^31 -
    1 blocks), over sed_tpu's n = n1 n2 (n1 = 2^(log2 n // 2)) of the frame
    (K1t, K3t) or of its m packed points (K6t)."""
    n_fft = 1 << log2_n
    plan = kernels.launch_plan(n_fft)
    for name in kernels.TIER_RANGES:
        if name not in plan or plan[name]["route"] == "one":
            continue
        parts = plan[name]["kernels"]
        assert parts[:2] == ("tier_inner", "tier_outer")
        assert parts[2:] == (("mel_log",) if name == "wave_stft_mel_log_bf16" else ())
        assert plan["tier_inner"]["smem"] == plan["tier_outer"]["smem"] == 0
        n = n_fft // 2 if name == "wave_packed_fft_bf16" else n_fft
        n1, n2 = stft_ops._matmul_fft_constants(n)[:2]
        assert tuple(1 << e for e in kernels._gemm_dims(n)) == (n1, n2)
