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
