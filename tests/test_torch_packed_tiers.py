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

import functools

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
# The tier GEMMs (tier_split_kernel, tier_inner_kernel, tier_outer_kernel):
# K1t and K3t at n_fft 128..1024 and 2^18..2^20, K6t at 256..2048 and
# 2^18..2^20, over a group of frames at a time.  The split pass writes the
# frames' bf16 chunks once, as X planes; stage 1 multiplies the table W
# (cuda_featurizer._gemm_images) by them on wgmma and writes the twiddled T
# as chunk planes; stage 2 multiplies T by V.  Every operand is a plane in
# the shared-memory image the tiles' bulk copies bring (featurizer.cu
# plane_byte).  The model below writes and reads the planes through that
# layout, multiplies over the tier's terms (float64 sums, rounded to
# float32) and runs each epilogue at the fragment positions of
# wgmma.m64nNk16 (row 16 warp + lane / 4 and 8 below it, column pair 8i + 2
# (lane mod 4)); every plane element and every output bin must be written
# once, and the result equal the plain version to the float32 rounding of
# the sums.  The shapes (a CTA tile's 128 rows of A and 128 rows of B, 64 at
# bf16x6; the planes' padding; the frame groups) are the model's copy of
# what the library's sed_tier_gemm_plan reports on the card.
# ---------------------------------------------------------------------------

GEMM_BM, GEMM_K, GEMM_SCRATCH = 128, 64, 1 << 31


def f32(a):
    return np.asarray(a, np.float32)


def gemm_bn(c):
    return 64 if c == 3 else 128


def round_up(x, m):
    return -(-x // m) * m


def gemm_shape(n, packed, passes, g):
    """featurizer.cu GemmShape of g frames of an n-point DFT."""
    log2_n1, log2_n2 = kernels._gemm_dims(n)
    n1, n2 = 1 << log2_n1, 1 << log2_n2
    c1, c2 = (kernels._tier_chunks(p) for p in passes)
    k1, k2 = n2 * (2 if packed else 1), 2 * n1
    s = dict(n1=n1, n2=n2, c1=c1, c2=c2, k1=k1, k2=k2, kt1=-(-k1 // GEMM_K),
             kt2=-(-k2 // GEMM_K), g=g, packed=packed,
             tab1_rows=round_up(2 * n2, GEMM_BM),
             tab2_rows=round_up(2 * n1 if packed else n1 + 8, gemm_bn(c2)),
             x_rows=round_up(g * n1, gemm_bn(c1)), t_rows=round_up(g * n2, GEMM_BM))
    s["x_bytes"] = 128 * c1 * s["kt1"] * s["x_rows"]
    s["t_bytes"] = 128 * c2 * s["kt2"] * s["t_rows"]
    return s


def gemm_group(n, packed, passes, frames):
    """featurizer.cu gemm_group: frames a group under GEMM_SCRATCH bytes."""
    def size(g):
        s = gemm_shape(n, packed, passes, g)
        return s["x_bytes"] + s["t_bytes"]
    if size(frames) <= GEMM_SCRATCH:
        return frames
    s = gemm_shape(n, packed, passes, 1)
    g = GEMM_SCRATCH // (128 * (s["c1"] * s["kt1"] * s["n1"] + s["c2"] * s["kt2"] * s["n2"]))
    while g > 1 and size(g) > GEMM_SCRATCH:
        g -= 1
    return max(g, 1)


def plane_index(c, r, k, kt, rows):
    """bf16 element of (chunk c, row r, k) of a plane (plane_byte / 2)."""
    return ((c * kt + k // 64) * rows + r) * 64 + (((k % 64) // 8) ^ (r % 8)) * 8 + k % 8


def read_planes(flat, chunks, rows, k, n_rows=None):
    """(chunks, n_rows, k) of a plane of ``rows`` rows, through plane_index."""
    r = np.arange(rows if n_rows is None else n_rows)[:, None]
    kk = np.arange(k)[None, :]
    return np.stack([flat[plane_index(c, r, kk, -(-k // 64), rows)] for c in range(chunks)])


def split_model(xw, n, packed, passes):
    """tier_split_kernel on a group of windowed frames ``xw`` ((g, n) real,
    or complex packed points): block (row tile rt, k tile kt) holds rows r =
    64 rt .. (r = f n1 + b) and k 64 kt .. (packed: points a = 64 kt .. of
    each row, Re z to k = a, Im z to n2 + a) as [k][r], then writes each
    (row, octet of k) as chunk stores of 8 values.  Returns the X planes (NaN
    where not written), how often each element was written, and the shape."""
    g = xw.shape[0]
    s = gemm_shape(n, packed, passes, g)
    n1, n2, c1 = s["n1"], s["n2"], s["c1"]
    rows = g * n1
    k_tiles = -(-n2 // 64) if packed else s["kt1"]
    flat = np.full(c1 * s["kt1"] * s["x_rows"] * 64, np.nan)
    writes = np.zeros(flat.shape, int)
    blk = np.arange(-(-rows // 64) * k_tiles)[:, None, None, None]
    r0, a0 = blk // k_tiles * 64, blk % k_tiles * 64
    count = np.minimum(64, (n2 if packed else s["k1"]) - a0)
    rl = np.arange(64)[None, :, None, None]            # the item's row
    o = np.arange(8)[None, None, :, None]              # its octet of k
    e = np.arange(8)[None, None, None, :]              # a value of the octet
    full = (blk.shape[0], 64, 8, 8)
    r, a = np.broadcast_to(r0 + rl, full), np.broadcast_to(a0 + 8 * o + e, full)
    keep = np.broadcast_to((8 * o < count) & (r0 + rl < rows), full)
    r, a = r[keep], a[keep]
    src = xw[r // n1, a * n1 + r % n1]
    for part in ((0, 1) if packed else (0,)):
        val = (src.imag if part else src.real) if packed else src
        for c, chunk in enumerate(chunks(val, c1)):
            idx = plane_index(c, r, a + part * n2, s["kt1"], s["x_rows"])
            flat[idx] = chunk
            np.add.at(writes, idx, 1)
    return flat, writes, s


def x_transposed(xw, n, packed):
    """X^T of the group: row f n1 + b, k = a (packed: Re z, then Im z)."""
    n1, n2 = (1 << e for e in kernels._gemm_dims(n))
    g = xw.shape[0]
    x = xw.reshape(g, n2, n1)
    if packed:
        x = np.concatenate([x.real, x.imag], axis=1)
    return x.transpose(0, 2, 1).reshape(g * n1, -1)


def inner_model(x_flat, s, inner):
    """tier_inner_kernel: T planes (NaN where not written), their writes and
    the f32 T they split, (g n2, 2 n1): [Tr | Ti] of row f n2 + k2."""
    n1, n2, c1, c2, g = s["n1"], s["n2"], s["c1"], s["c2"], s["g"]
    w_img, _, tw = kernels._gemm_images(1 << (n1 * n2).bit_length() - 1, s["packed"], c1, c2,
                                       s["tab1_rows"], s["tab2_rows"], CPU)
    a = read_planes(w_img.float().numpy().astype(np.float64), c1, s["tab1_rows"], s["k1"])
    b = read_planes(x_flat, c1, s["x_rows"], s["k1"], g * n1)
    d = f32(sum(a[ca] @ b[cb].T for ca, cb in TERMS[inner]))   # (tab1_rows, g n1)
    tw = tw.numpy()
    # The fragments' rows 16t + lane / 4 (Yr at k2 = 8t + lane / 4; Yi 8 below)
    # and column pairs (b, b + 1) of every tile that holds data.
    rows = np.arange(s["tab1_rows"])
    rows = rows[(rows % 16 < 8) & (rows // 16 * 8 + rows % 8 < n2)][:, None]
    cols = np.arange(0, g * n1, 2)[None, :]
    k2 = rows // 16 * 8 + rows % 8
    f, bb = cols // n1, cols % n1
    flat = np.full(c2 * s["kt2"] * s["t_rows"] * 64, np.nan)
    writes = np.zeros(flat.shape, int)
    t = np.full((g * n2, 2 * n1), np.nan, np.float32)
    for h in (0, 1):   # columns b, b + 1
        yr, yi = d[rows, cols + h], d[rows + 8, cols + h]
        twr, twi = tw[k2, bb + h, 0], tw[k2, bb + h, 1]
        tr = f32(f32(yr * twr) - f32(yi * twi))
        ti = f32(f32(yr * twi) + f32(yi * twr))
        rt = f * n2 + k2
        for k, v in ((bb + h, tr), (n1 + bb + h, ti)):
            t[rt, k] = v
            for c, chunk in enumerate(chunks(v, c2)):
                idx = plane_index(c, rt, k, s["kt2"], s["t_rows"])
                flat[idx] = chunk
                np.add.at(writes, idx, 1)
    return flat, writes, t


def outer_model(t_flat, s, outer):
    """tier_outer_kernel: (g, n/2 + 1) power, or (g, n) complex Z (packed)."""
    n1, n2, c2, g = s["n1"], s["n2"], s["c2"], s["g"]
    n = n1 * n2
    _, v_img, _ = kernels._gemm_images(n, s["packed"], s["c1"], c2, s["tab1_rows"],
                                       s["tab2_rows"], CPU)
    a = read_planes(t_flat, c2, s["t_rows"], s["k2"], g * n2)
    b = read_planes(v_img.float().numpy().astype(np.float64), c2, s["tab2_rows"], s["k2"])
    d = f32(sum(a[ca] @ b[cb].T for ca, cb in TERMS[outer]))   # (g n2, tab2_rows)
    packed = s["packed"]
    out = np.full((g, n if packed else n // 2 + 1), np.nan,
                  np.complex128 if packed else np.float64)
    written = np.zeros(out.shape, int)
    rows = np.arange(g * n2)[:, None]
    k1 = np.arange(s["tab2_rows"] // 2)[None, :]
    f, k2 = rows // n2, rows % n2
    zr, zi = d[rows, 2 * k1], d[rows, 2 * k1 + 1]
    sel = (k1 < n1) if packed else (k1 < n1 // 2) | ((k1 == n1 // 2) & (k2 == 0))
    sel = np.broadcast_to(sel, zr.shape)
    idx = (np.broadcast_to(f, zr.shape)[sel], np.broadcast_to(n2 * k1 + k2, zr.shape)[sel])
    if packed:
        out[idx] = zr[sel] + 1j * zi[sel].astype(np.float64)
    else:
        out[idx] = f32(f32(zr[sel] * zr[sel]) + f32(zi[sel] * zi[sel]))
    np.add.at(written, idx, 1)
    assert (written == 1).all()
    return out


def windowed_frames(kind, n_fft, seed):
    """Three frames as the split pass reads them, windowed, with the plain
    version's input beside: kind 0 K1's centred frames of a waveform, 1 K3's
    float32 rows, 2 its int16 rows (the window scaled by 1/32768)."""
    rng = np.random.default_rng(seed)
    window = torch.from_numpy(np.hanning(n_fft + 2)[1:-1].astype(np.float32))
    hop = n_fft // 2
    if kind == 0:
        waves = torch.from_numpy(rng.standard_normal((1, 2 * hop + 5)).astype(np.float32))
        return (stft_ops.frame_signal(waves, n_fft, hop) * window)[0].numpy()
    rows = rng.standard_normal((3, n_fft)).astype(np.float32)
    if kind == 1:
        return rows * window.numpy()
    pcm = np.round(np.clip(rows, -4, 4) * 8000).astype(np.int16)
    return pcm.astype(np.float32) * (window / 32768.0).numpy()


SPLIT_CASES = [(kind, n_fft, packed) for n_fft in (128, 1024, 262144)
               for kind, packed in ((0, False), (1, False), (2, False), (0, True))
               if not (packed and n_fft < 256)]


@pytest.mark.parametrize("kind, n_fft, packed", SPLIT_CASES, ids=str)
def test_split_pass_planes_are_the_windowed_frames_chunks(kind, n_fft, packed):
    """The split pass writes every element of the group's X planes once, and
    chunk c of row f n1 + b at k = a is chunk c of split_bf16 of the windowed
    frame's x[a n1 + b] (packed: of Re z, then Im z, of point a n1 + b), for
    K1t's framing, K3t's float32 and int16 rows and K6t's packed points, at
    three chunks (bf16x6; fewer chunks are its first ones)."""
    xw = windowed_frames(kind, n_fft, n_fft + kind)
    n = n_fft // 2 if packed else n_fft
    if packed:
        xw = xw[:, 0::2] + 1j * xw[:, 1::2]
    flat, writes, s = split_model(xw, n, packed, (6, 6))
    got = read_planes(flat, s["c1"], s["x_rows"], s["k1"], s["g"] * s["n1"])
    want = chunks(x_transposed(xw, n, packed), 3)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    logical = plane_index(np.arange(3)[:, None, None], np.arange(s["g"] * s["n1"])[:, None],
                          np.arange(s["k1"])[None, :], s["kt1"], s["x_rows"])
    assert (writes[logical] == 1).all() and writes.sum() == logical.size


@pytest.mark.parametrize("n_fft, precision", [(512, "bf16x6"), (1024, ("bf16x1", "bf16x3")),
                                              (262144, "bf16x3")], ids=str)
def test_t_planes_are_the_twiddled_t_split(n_fft, precision):
    """Stage 1's epilogue writes every element of the T planes once (row f n2
    + k2, k = b for Tr, n1 + b for Ti): chunk c equals chunk c of
    split_bf16 of the f32 T, which is within 2e-6 x its peak of the plain
    version's stage 1 (``_tier_inner_plain``; float32 sums in another order)."""
    passes = kernels.tier_passes(precision)
    xw = windowed_frames(0, n_fft, 7)
    flat_x, _, s = split_model(xw, n_fft, False, passes)
    flat, writes, t = inner_model(flat_x, s, passes[0])
    n1, n2, g = s["n1"], s["n2"], s["g"]
    got = read_planes(flat, s["c2"], s["t_rows"], s["k2"], g * n2)   # (c2, g n2, 2 n1)
    logical = plane_index(np.arange(s["c2"])[:, None, None], np.arange(g * n2)[:, None],
                          np.arange(2 * n1)[None, :], s["kt2"], s["t_rows"])
    assert (writes[logical] == 1).all() and writes.sum() == logical.size
    tr, ti = kernels._tier_inner_plain(torch.from_numpy(xw), n_fft, passes[0])
    want = np.concatenate([tr.numpy(), ti.numpy()], axis=-1).reshape(g * n2, 2 * n1)
    assert all(np.array_equal(a, b) for a, b in zip(got, chunks(t, s["c2"])))
    assert np.abs(t - want).max() <= 2e-6 * np.abs(want).max()


GEMM_CASES = [(128, "bf16x3", False), (128, "bf16x1", False), (256, ("bf16x6", "bf16x4"), False),
              (512, "bf16x6", False), (1024, "bf16x3", False), (65536, "bf16x3", False),
              (131072, "bf16x6", False), (262144, "bf16x3", False),
              (1048576, "bf16x1", False), (256, "bf16x3", True), (512, ("bf16x1", "bf16x6"), True),
              (1024, "bf16x4", True), (2048, "bf16x3", True), (262144, "bf16x6", True),
              (1048576, "bf16x3", True)]


@pytest.mark.parametrize("n_fft, precision, packed", GEMM_CASES, ids=str)
def test_model_of_the_tier_gemms_matches_the_plain_version(n_fft, precision, packed):
    """K1t's power (``_tier_power_plain``) or K6t's Z (``_tier_packed_plain``)
    of 3 frames through the split pass and both stages: n1 = 8 (a quarter of
    a 64-deep k tile, stage 1's 32 rows of a 128-row tile) up to n1 = 1024,
    n2 = 1024, n1 = 256 (n_fft 65536 and 131072, where no fused shape fits
    and K1t runs the GEMMs; bf16x6 there too); within 5e-6 x the frame's
    peak, 1.5e-3 where the outer stage is bf16x1 (its one rounding)."""
    passes = kernels.tier_passes(precision)
    x = np.random.default_rng(n_fft).standard_normal((3, n_fft)).astype(np.float32)
    n = n_fft // 2 if packed else n_fft
    xw = x[:, 0::2] + 1j * x[:, 1::2] if packed else x
    flat_x, _, s = split_model(xw, n, packed, passes)
    got = outer_model(inner_model(flat_x, s, passes[0])[0], s, passes[1])
    if packed:
        wr, wi = kernels._tier_packed_plain(torch.from_numpy(x), n_fft, passes)
        want = wr.double().numpy() + 1j * wi.double().numpy()
    else:
        want = kernels._tier_power_plain(torch.from_numpy(x), n_fft, passes).double().numpy()
    assert got.shape == want.shape
    tol = 1.5e-3 if passes[1] == 1 else 5e-6
    peak = np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(got - want) <= tol * peak).all()


def trunc32(x):
    """float64 -> float32 rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def wgmma_sum(ac, bc, passes, depth):
    """sum over the tier's terms of ac[ca] @ bc[cb] as the kernels take it, in
    a model of the tensor cores' accumulation: each k16 step of a term adds
    its exact products to the accumulator and truncates it to float32.  With
    ``depth`` each run of that many k goes to an accumulator of its own, added
    to the total in float32 (round to nearest); None: one running sum."""
    k = ac[0].shape[1]
    depth = depth or k
    total = np.zeros((ac[0].shape[0], bc[0].shape[1]), np.float32)
    for k0 in range(0, k, depth):
        part = np.zeros_like(total)
        for j in range(k0, min(k, k0 + depth), 16):
            for ca, cb in TERMS[passes]:
                part = trunc32(part.astype(np.float64) + ac[ca][:, j:j + 16] @ bc[cb][j:j + 16])
        total = f32(total + part)
    return total


@functools.lru_cache(maxsize=1)
def frame_2_20():
    """One frame of noise at n_fft 2^20, its plain power at bf16x6."""
    x = np.random.default_rng(20).standard_normal(1 << 20).astype(np.float32)
    return x, kernels._tier_power_plain(torch.from_numpy(x[None]), 1 << 20, (6, 6))[0].numpy()


@pytest.mark.parametrize("depth, holds", [(GEMM_K, True), (None, False)], ids=str)
def test_partial_per_k_tile_holds_tier_rel_tol_at_bf16x6(depth, holds):
    """At n_fft 2^20 and bf16x6 (stage 1's k 1024, stage 2's 2048), on one
    frame (32 of its k2 rows, each bin k1 < n1/2 of them): the kernels'
    accumulator a 64-deep k tile, added in float32, holds ``tier_rel_tol``
    (3e-5 x the frame's peak) of the plain version in the model of the
    tensor cores' truncating accumulation (2.2e-6 here); one running sum over
    all k does not (4e-5: what PR-era measurements on the card found)."""
    x, want = frame_2_20()
    n = 1 << 20
    w, v, tw = kernels.gemm_operands(n, False)
    n1 = n2 = 1024
    k2s = np.arange(0, n2, 32)
    rows = np.stack([16 * (k2s // 8) + k2s % 8, 16 * (k2s // 8) + 8 + k2s % 8], 1).reshape(-1)
    y = wgmma_sum(chunks(w[rows], 3), chunks(x.reshape(n2, n1), 3), 6, depth)
    yr, yi = y.reshape(len(k2s), 2, n1).transpose(1, 0, 2)
    twr, twi = tw[k2s, :, 0], tw[k2s, :, 1]
    tr, ti = f32(f32(yr * twr) - f32(yi * twi)), f32(f32(yr * twi) + f32(yi * twr))
    z = wgmma_sum(chunks(np.concatenate([tr, ti], axis=1), 3), [c.T for c in chunks(v, 3)], 6,
                  depth)
    zr, zi = z[:, 0:n1:2], z[:, 1:n1:2]
    got = f32(f32(zr * zr) + f32(zi * zi)).T            # (k1 < n1/2, k2)
    err = np.abs(got - want[n2 * np.arange(n1 // 2)[:, None] + k2s]).max() / np.abs(want).max()
    assert (err <= 3e-5) == holds, err


@pytest.mark.parametrize("n_fft, packed", [(128, False), (1024, False), (2048, True),
                                           (262144, False), (524288, False), (1048576, False),
                                           (262144, True), (1048576, True)], ids=str)
def test_frame_groups_cover_every_frame_once(n_fft, packed):
    """At every pass count, 16 x 60 s (2912 frames) and a few frames go in
    groups whose planes stay under the library's 2 GiB: every frame in
    exactly one group, in order; all in one group at the small end."""
    n = n_fft // 2 if packed else n_fft
    for passes in [(a, b) for a in (1, 3, 4, 6) for b in (1, 3, 4, 6)]:
        for frames in (2912, 5):
            group = gemm_group(n, packed, passes, frames)
            s = gemm_shape(n, packed, passes, group)
            assert s["x_bytes"] + s["t_bytes"] <= GEMM_SCRATCH or group == 1
            groups = kernels.frame_groups(frames, group)
            covered = np.concatenate([np.arange(r, r + g) for r, g in groups])
            assert np.array_equal(covered, np.arange(frames))
            assert all(0 < g <= group for _, g in groups)
            if n_fft <= 2048:
                assert len(groups) == 1


@pytest.mark.parametrize("log2_n", [7, 8, 9, 10, 11, 18, 19, 20])
def test_gemm_plans_follow_sed_tpus_factorisation(log2_n):
    """Where the tier GEMMs run (launch_plan's route 'gemm', K5t's 'chain'),
    the split pass and their two stages are entries of their own (the split
    pass with static shared memory only; the stages' from the library,
    None without a card), over sed_tpu's n = n1 n2 (n1 = 2^(log2 n // 2)) of
    the frame (K1t, K3t) or of its m packed points (K6t).  At n_fft 2048
    K1t's, K3t's and K5t's route is the library's (None here)."""
    n_fft = 1 << log2_n
    plan = kernels.launch_plan(n_fft)
    for name in kernels.TIER_RANGES:
        if name not in plan or plan[name]["route"] not in ("gemm", "chain"):
            assert name not in plan or plan[name]["route"] == (
                "one" if name == "wave_packed_fft_bf16" else None)
            continue
        parts = plan[name]["kernels"]
        assert parts[:3] == kernels.GEMM_KERNELS == ("tier_split", "tier_inner", "tier_outer")
        assert parts[3:] == (("mel_log",) if name == "wave_stft_mel_log_bf16" else ())
        assert plan["tier_split"]["smem"] == 0
        assert plan["tier_inner"]["smem"] is None and plan["tier_outer"]["smem"] is None
        n = n_fft // 2 if name == "wave_packed_fft_bf16" else n_fft
        n1, n2 = stft_ops._matmul_fft_constants(n)[:2]
        assert tuple(1 << e for e in kernels._gemm_dims(n)) == (n1, n2)


# ---------------------------------------------------------------------------
# The fused route (tier_fused_kernel): K1t and K3t (and K5t, K1t's route then
# K2) where the library's sed_tier_fused_plan takes the size and passes (n_fft
# 2048..32768, n1 32..128, at most two stage-1 passes).  The
# split pass writes the X planes as above; then one kernel takes both stages
# of each unit (frame, 64 k2 rows): stage 1 multiplies the unit's 128 rows of
# the tab1 plane by the frame's X plane, np columns b a pass, a partial a
# 64-deep k tile; its epilogue twiddles and splits T into shared memory (64
# rows k2, K = [Tr | Ti] over b, in the swizzled K-major image wgmma reads);
# stage 2 multiplies T by the tab2 plane's n1 + 8 rows, the two multiplying
# warpgroups half of the one-sided columns each (warpgroup 2 also bin n /
# 2's), and drains |Z|^2 to the natural bins.  The model below follows that
# data flow
# with the kernel's fragment positions; the shape (np, ring slots) is the
# model's copy of featurizer.cu fused_shape, which the library reports on
# the card (sed_tier_fused_plan, held against it by test_torch_cuda.py).
# ---------------------------------------------------------------------------

def fused_shape(n1, passes):
    """featurizer.cu fused_shape: the first np (n1, then halves down to 32)
    and ring slots (4, 3, 2) whose T, ring and barriers fit 227 KB; None
    above n1 128 (those sizes run the tier GEMMs)."""
    c1, c2 = (kernels._tier_chunks(p) for p in passes)
    if not 32 <= n1 <= 128:
        return None
    np_ = n1
    while np_ >= 32:
        for slots in (4, 3, 2):
            slot = max(c1 * (128 + np_) * 128, c2 * (n1 + 8) * 128)
            smem = c2 * n1 * 256 + slots * slot + 8 * 2 * slots + 1024
            if smem <= 232448:
                return {"np": np_, "slots": slots, "slot": slot, "smem": smem}
        np_ //= 2
    return None


def fused_route(n1, passes):
    """featurizer.cu fused_route: whether K1t and K3t take the fused kernel
    (else the tier GEMMs): a shape fits, in at most two stage-1 passes."""
    shape = fused_shape(n1, passes)
    return shape is not None and 2 * shape["np"] >= n1


def stage1_fragments(n1, np_):
    """(k2 row of the unit, b) of each stage-1 accumulator value the two
    warpgroups hold after every pass, as the epilogue reads them: warpgroup w,
    warp, lane (g = lane / 4, tig = lane mod 4), column pair i: k2 = 32 w + 8
    warp + g (Yr at tile row 64 w + 16 warp + g, Yi 8 below), b = h np + 8 i +
    2 tig and b + 1."""
    w, warp, lane, i, e, h = np.meshgrid(np.arange(2), np.arange(4), np.arange(32),
                                         np.arange(np_ // 8), np.arange(2),
                                         np.arange(n1 // np_), indexing="ij")
    k2 = 32 * w + 8 * warp + lane // 4
    b = h * np_ + 8 * i + 2 * (lane % 4) + e
    row = 64 * w + 16 * warp + lane // 4          # the Yr row of the tab1 tile
    assert np.array_equal(row // 16 * 8 + row % 8, k2)
    return k2.ravel(), b.ravel()


def stage2_fragments(n1, nyquist):
    """(k2 row, k1) of each stage-2 (Zr, Zi) pair the drain squares:
    warpgroup w's columns w n1/2 .. (k1 = n1/4 w + 4 i + tig), rows 16 warp +
    g + 8 hh; with ``nyquist`` (a frame's first unit) warpgroup 2's extra
    8 columns, of which warp 0's lane 0 holds bin n / 2 (k1 = n1 / 2, k2 = 0)."""
    nb = n1 // 2
    w, warp, lane, i, hh = np.meshgrid(np.arange(2), np.arange(4), np.arange(32),
                                       np.arange(nb // 8), np.arange(2), indexing="ij")
    k1 = nb // 2 * w + 4 * i + lane % 4
    k2 = 16 * warp + lane // 4 + 8 * hh
    k1, k2 = k1.ravel(), k2.ravel()
    if nyquist:
        k1, k2 = np.append(k1, n1 // 2), np.append(k2, 0)
    return k2, k1


@pytest.mark.parametrize("n_fft", [2048, 4096, 8192, 16384, 32768])
def test_fused_fragments_cover_every_element_once(n_fft):
    """At every fused size and shape: stage 1's epilogue writes every (k2, b)
    of a unit's T once over its passes; stage 2's drain every one-sided bin
    of the unit's 64 k2 rows once (and bin n / 2 in a frame's first unit); T's
    image, each unit's 64 rows, holds every (chunk, k2, k) once."""
    n1 = 1 << ((n_fft.bit_length() - 1) // 2)
    for passes in [(a, b) for a in (1, 3, 4, 6) for b in (1, 3, 4, 6)]:
        shape = fused_shape(n1, passes)
        assert shape is not None and n1 % shape["np"] == 0 and shape["slot"] % 1024 == 0
        k2, b = stage1_fragments(n1, shape["np"])
        seen = np.zeros((64, n1), int)
        np.add.at(seen, (k2, b), 1)
        assert (seen == 1).all()
        c2 = kernels._tier_chunks(passes[1])
        kt2 = 2 * n1 // 64
        idx = plane_index(np.arange(c2)[:, None, None], np.arange(64)[:, None],
                          np.arange(2 * n1)[None, :], kt2, 64)
        assert np.array_equal(np.sort(idx.ravel()), np.arange(c2 * kt2 * 64 * 64))
        for nyquist in (False, True):
            k2, k1 = stage2_fragments(n1, nyquist)
            bins = np.zeros((64, n1 // 2 + 1), int)
            np.add.at(bins, (k2, k1), 1)
            assert (bins[:, : n1 // 2] == 1).all()
            assert bins[0, n1 // 2] == int(nyquist) and bins[1:, n1 // 2].sum() == 0


def fused_model(xw, n, passes, kind=0):
    """tier_fused_kernel (K1t, K3t) on a group of windowed frames ``xw`` (g,
    n): the split pass's X planes, then each unit's two stages as the kernel
    takes them.  Returns the (g, n/2 + 1) power (every bin written once), each
    frame's f32 T (g n2, 2 n1) and its chunks as read back from each unit's T
    image."""
    inner, outer = passes
    flat_x, _, s = split_model(xw, n, False, passes)
    n1, n2, c1, c2, g = s["n1"], s["n2"], s["c1"], s["c2"], s["g"]
    np_ = fused_shape(n1, passes)["np"]
    w_img, v_img, tw = kernels._gemm_images(n, False, c1, c2, s["tab1_rows"], s["tab2_rows"], CPU)
    tab1 = read_planes(w_img.float().numpy().astype(np.float64), c1, s["tab1_rows"], s["k1"])
    x = read_planes(flat_x, c1, s["x_rows"], s["k1"], g * n1)
    tab2 = read_planes(v_img.float().numpy().astype(np.float64), c2, s["tab2_rows"], s["k2"])
    tw = tw.numpy()
    kt2 = 2 * n1 // 64
    n_blk = n2 // 64
    out = np.full((g, n // 2 + 1), np.nan)
    written = np.zeros(out.shape, int)
    t_f32 = np.full((g * n2, 2 * n1), np.nan, np.float32)
    t_chunks = np.full((c2, g * n2, 2 * n1), np.nan)
    for f in range(g):
        for blk in range(n_blk):
            k0 = 64 * blk
            a = tab1[:, 128 * blk:128 * blk + 128]            # the unit's Yr, Yi rows
            image = np.full(c2 * kt2 * 64 * 64, np.nan)
            for h in range(n1 // np_):
                b = x[:, f * n1 + h * np_:f * n1 + (h + 1) * np_]
                acc = np.zeros((128, np_), np.float32)
                for kt in range(n2 // 64):                  # a partial a 64-deep k tile
                    ks = slice(64 * kt, 64 * kt + 64)
                    part = f32(sum(a[ca][:, ks] @ b[cb][:, ks].T for ca, cb in TERMS[inner]))
                    acc = f32(acc + part)
                k2l, bb = stage1_fragments(n1, np_)
                keep = bb // np_ == h
                k2l, bb = k2l[keep], bb[keep]
                row = 64 * (k2l // 32) + 16 * (k2l % 32 // 8) + k2l % 8
                yr, yi = acc[row, bb - h * np_], acc[row + 8, bb - h * np_]
                twr, twi = tw[k0 + k2l, bb, 0], tw[k0 + k2l, bb, 1]
                tr = f32(f32(yr * twr) - f32(yi * twi))
                ti = f32(f32(yr * twi) + f32(yi * twr))
                for k, v in ((bb, tr), (n1 + bb, ti)):
                    t_f32[f * n2 + k0 + k2l, k] = v
                    for c, chunk in enumerate(chunks(v, c2)):
                        image[plane_index(c, k2l, k, kt2, 64)] = chunk
            t = read_planes(image, c2, 64, 2 * n1)            # as stage 2's descriptors read it
            t_chunks[:, f * n2 + k0:f * n2 + k0 + 64] = t
            acc2 = np.zeros((64, n1 + 8), np.float32)
            for kt in range(kt2):                           # one running sum over 2 n1
                ks = slice(64 * kt, 64 * kt + 64)
                acc2 = f32(acc2 + sum(t[ca][:, ks] @ tab2[cb][:n1 + 8, ks].T
                                      for ca, cb in TERMS[outer]))
            k2l, k1 = stage2_fragments(n1, blk == 0)
            zr, zi = acc2[k2l, 2 * k1], acc2[k2l, 2 * k1 + 1]
            power = f32(f32(zr * zr) + f32(zi * zi))
            bins = np.where(k1 == n1 // 2, n // 2, n2 * k1 + k0 + k2l)
            out[f, bins] = power
            np.add.at(written, (f, bins), 1)
    assert (written == 1).all()
    return out, t_f32, t_chunks, s


FUSED_CASES = [(2048, "bf16x3", 0), (2048, "bf16x6", 1), (2048, ("bf16x1", "bf16x3"), 2),
               (8192, "bf16x4", 0), (8192, "bf16x1", 2), (32768, "bf16x3", 0),
               (32768, "bf16x6", 1), (32768, ("bf16x6", "bf16x4"), 2),
               (32768, ("bf16x3", "bf16x6"), 0)]


@pytest.mark.parametrize("n_fft, precision, kind", FUSED_CASES, ids=str)
def test_model_of_the_fused_route_matches_the_plain_version(n_fft, precision, kind):
    """K1t's framing (kind 0) and K3t's float32 (1) and int16 rows (2)
    through the split pass and the fused kernel's model, at n1 32, 64 and 128
    with one pass (np = n1) or, at a 6-pass inner stage, several: T's chunks
    as stage 2 reads them equal split_bf16 of the twiddled f32 T, which is
    within 2e-6 x its peak of the plain version's stage 1; every bin written
    once, within 5e-6 x the frame's peak of the plain version (1.5e-3 where
    the outer stage is bf16x1)."""
    passes = kernels.tier_passes(precision)
    xw = windowed_frames(kind, n_fft, n_fft + kind)
    got, t, t_chunks, s = fused_model(xw, n_fft, passes)
    for c, chunk in enumerate(chunks(t, s["c2"])):
        assert np.array_equal(t_chunks[c], chunk)
    tr, ti = kernels._tier_inner_plain(torch.from_numpy(xw), n_fft, passes[0])
    want_t = np.concatenate([tr.numpy(), ti.numpy()], axis=-1).reshape(t.shape)
    assert np.abs(t - want_t).max() <= 2e-6 * np.abs(want_t).max()
    want = kernels._tier_power_plain(torch.from_numpy(xw), n_fft, passes).double().numpy()
    tol = 1.5e-3 if passes[1] == 1 else 5e-6
    peak = np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(got - want) <= tol * peak).all()


@pytest.mark.parametrize("n_fft, precision", [(2048, "bf16x3"), (8192, "bf16x1"),
                                              (16384, ("bf16x6", "bf16x4")), (32768, "bf16x3")],
                         ids=str)
def test_model_of_k5t_reads_the_power_k1t_writes(n_fft, precision):
    """K5t is K1t's route, then K2: K2's band sums (segments of 256 bins in
    the table's order, each band its segments' sum) of the fused route's
    power, as the model writes it, are K2's plain version of that power
    within 1e-4 dB, and that power is K1t's plain version within 5e-6 x the
    frame's peak."""
    passes = kernels.tier_passes(precision)
    xw = windowed_frames(0, n_fft, 3)
    power, _, _, _ = fused_model(xw, n_fft, passes)
    plain = kernels._tier_power_plain(torch.from_numpy(xw), n_fft, passes).double().numpy()
    tol = 1.5e-3 if passes[1] == 1 else 5e-6
    assert (np.abs(power - plain) <= tol * np.abs(plain).max(axis=-1, keepdims=True)).all()
    cfg = kernels.SpectrogramConfig(working_sample_rate=int(0.75 * n_fft / 0.66))
    assert cfg.nfft == n_fft
    bands = kernels.mel_bands(cfg, CPU)
    w = bands.weights.numpy().astype(np.float64)
    sums = np.array([[(power[f, s0:s0 + cnt] * w[off:off + cnt]).sum()
                      for s0, cnt, off, _ in bands.segments.numpy()]
                     for f in range(power.shape[0])])
    first = bands.band_first.numpy()
    mel = np.stack([sums[:, first[b]:first[b + 1]].sum(axis=1) for b in range(bands.n_mels)], 1)
    got = 10 * np.log10(np.maximum(mel, 1e-10))
    want = kernels.mel_log_plain(torch.from_numpy(power).double(), bands.dense.double()).numpy()
    assert np.abs(got - want).max() <= 1e-4


class _FakePlanLibrary:
    """The kernel library's plan entries as a card would answer them: the
    fused route where featurizer.cu's fused_route takes the size and passes
    (this file's models of it and of fused_shape), with arbitrary marks in
    the keys no model here computes."""

    def sed_tier_fused_plan(self, log2_n, inner, outer, frames, device, values):
        n1 = 1 << (log2_n // 2)
        shape = fused_shape(n1, (inner, outer))
        got = [0] * 11
        if shape is not None:
            got = [int(fused_route(n1, (inner, outer))), frames, 1000 + log2_n, 0, 0, 288,
                   shape["smem"], 64, shape["np"], shape["slots"], 132]
        for i, v in enumerate(got):
            values[i] = v
        return 0

    def sed_tier_gemm_plan(self, log2_n1, log2_n2, packed, inner, outer, frames, values):
        for i, v in enumerate([frames, 0, 0, 0, 0, 111_000, 222_000]):
            values[i] = v
        return 0

    def sed_mel_plan(self, rows, n_seg, n_mels, device, rows_at_once, smem):
        rows_at_once._obj.value, smem._obj.value = 4, 333
        return 0


@pytest.mark.parametrize("log2_n", kernels.TIER_LOG2_N)
def test_launch_plan_reads_the_fused_route_from_the_library(log2_n, monkeypatch):
    """K1t's and K3t's route and shared memory at every size of TIER_LOG2_N
    and every pass count are the library's answer (sed_tier_fused_plan), not
    a Python layout, and K5t follows K1t: with a card's answers in place,
    launch_plan reports them (the fused route, the split pass then
    tier_fused_kernel, where fused_route takes the size and passes; the tier
    GEMMs elsewhere; K5t K1t's kernels, the fused one under its own name,
    then K2); without the passes, the route where every pass count agrees,
    else None; without a card, None."""
    n_fft = 1 << log2_n
    plan = kernels.launch_plan(n_fft, 10)
    for name in ("wave_dft_power_bf16", "frames_dft_power_bf16", "wave_stft_mel_log_bf16"):
        if log2_n in kernels.TIER_RANGES[name]:
            assert set(plan[name].values()) == {None}
    assert not hasattr(kernels, "tier_smem_bytes")
    kernels._fused_plan.cache_clear()
    kernels._gemm_plan.cache_clear()
    monkeypatch.setattr(kernels, "_library", lambda: _FakePlanLibrary())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    every = [(a, b) for a in (1, 3, 4, 6) for b in (1, 3, 4, 6)]
    try:
        plans = {q: kernels.launch_plan(n_fft, 10, passes=q) for q in [None] + every}
    finally:
        kernels._fused_plan.cache_clear()
        kernels._gemm_plan.cache_clear()
    n1 = 1 << (log2_n // 2)
    routes = {q: "fused" if fused_route(n1, q) else "gemm" for q in every}
    agreed = set(routes.values()).pop() if len(set(routes.values())) == 1 else None
    for q, plan in plans.items():
        route = routes[q] if q else agreed
        k1t = plan["wave_dft_power_bf16"]
        for name in ("wave_dft_power_bf16", "frames_dft_power_bf16", "wave_stft_mel_log_bf16"):
            if log2_n not in kernels.TIER_RANGES[name]:
                continue
            p = plan[name]
            if route is None:
                assert set(p.values()) == {None}
            elif name == "wave_stft_mel_log_bf16":
                assert p["route"] == "chain" and p["cluster"] == 1
                assert p["kernels"] == tuple(name if k == "wave_dft_power_bf16" else k
                                             for k in k1t["kernels"]) + ("mel_log",)
            elif route == "fused":
                assert p["route"] == "fused" and p["kernels"] == ("tier_split", name)
                assert p["smem"] == max(fused_shape(n1, r)["smem"]
                                        for r in ([q] if q else every)) <= 232448
                assert p["cluster"] == 1 and plan["tier_split"]["route"] == "one"
            else:
                assert p["route"] == "gemm" and p["kernels"] == kernels.GEMM_KERNELS
