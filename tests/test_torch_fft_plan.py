"""A float64 numpy model of the Stockham FFT kernels, held against numpy.

K1 (``wave_stft_power_kernel``), K3 (``frames_stft_power_kernel``), K5
(``wave_stft_mel_log_kernel``) and K6 (``wave_packed_fft_kernel``) in
``sed_tpu_torch/ops/csrc/featurizer.cu`` run their m-point complex FFT
through ``stockham_fft``: radix-16 Stockham passes held in registers, then
one radix-r pass, with the points going once through shared memory between
passes.  K6 stores Z in natural order (``SplitStore``); K1, K3 and K5 unpack
it to one-sided power (``PowerStore``, the drain), and K5 then sums the mel
bands.  The functions below carry the kernel's names and compute exactly
its indices:

  * :func:`radix_plan`      m = 16^a * r -> a radix-16 passes, then radix r;
  * :func:`thread_count`    T threads, each holding :data:`POINTS` points;
  * :func:`slot_index`      register slot s of thread t holds point t + T*s:
                            where the first pass loads, where every pass
                            reads the exchange, where the last pass stores;
  * :func:`table_index`     W_{pR}^(q*k) as an index into the table
                            W_{2m}^j (j < m) of ``stft_ops.unpack_twiddles``;
  * :func:`twiddle_index`   where the kernel reads it: entry q*p + k - 1 of
                            that table's values in pass order
                            (:func:`pass_twiddles`, the port's
                            ``stft_ops.stockham_twiddles``);
  * :func:`exchange_index`  where output q of butterfly i goes (Stockham);
  * :func:`swizzle`         the bank swizzle of the shared exchange buffer;
  * :func:`drain_partner`   the thread and slot that hold Z[m-k] for the
                            drain's bin k;
  * :func:`drain_write_index`, :func:`drain_read_index`  the drain's own
                            exchange, in natural order, no swizzle.

The tests run the model on seeded random input for every m the kernels take
(log2 m = 1..14, n_fft 4..32768), check that every exchange is a
permutation free of shared-memory bank conflicts, and run the models of the
whole of K6 (framing, window, packing), of the whole of K3 (row fill,
float32 and int16, drain) and of the whole of K1 (K6's loader, the drain)
against the port's plain versions.

The band sums of K2 and K5 follow one order, a function of the band alone:
each band cut into segments of ``MEL_SEGMENT_BINS`` bins
(``mel_segments_numpy``), each segment summed as a warp sums it
(``segment_sums``: lane sums, then the shuffle tree) and the band as its
segments' sum left to right (``band_sum``).  The float32 model below holds
K5's one-thread order (``segment_sum_by_thread``, below 32 threads) bit for
bit against the warps', and the segment order against the one-warp
order over a whole band for bands no wider than a segment.  K2's ring is modelled too
(``mel_chunk``, ``segment_step``): which bins each chunk's bulk copy and
scalar loads bring for every row alignment, and that each segment's bins
are resident, at distinct ring positions, at the step its warp sums it.
"""

import numpy as np
import pytest
import torch

from sed_tpu_torch.ops import cuda_featurizer as kernels
from sed_tpu_torch.ops import stft as stft_ops

POINTS = 16   # points a thread holds in registers (kPoints)
WARP = 32
BANKS = 32
LOG2_M = range(1, 15)


def radix_plan(log2_m: int) -> list:
    """Radices of the passes: m = 16^a * r with r in {1, 2, 4, 8}; a
    radix-16 passes, then one radix-r pass where r > 1."""
    a, rest = divmod(log2_m, 4)
    return [16] * a + ([1 << rest] if rest else [])


def thread_count(log2_m: int) -> int:
    """Threads of the block: m / 16, or one thread for m < 16."""
    return max(1, (1 << log2_m) // POINTS)


def points_per_thread(log2_m: int) -> int:
    return min(POINTS, 1 << log2_m)


def slot_index(t, s, T):
    """Point held in register slot s of thread t (0 <= s < points)."""
    return t + T * s


def table_index(q, k, p, R, m):
    """Index of W_{pR}^(q*k) = W_{2m}^(q*k*2m/(pR)) in [0, 2m)."""
    return q * k * (2 * m // (p * R))


def table_at(table, idx, m):
    """W_{2m}^idx from the table of W_{2m}^j, j < m: W^(j+m) = -W^j."""
    idx = np.asarray(idx)
    return np.where(idx < m, 1.0, -1.0) * table[idx % m]


def twiddle_index(q, k, p):
    """Entry of W_{pR}^(q*k) in the pass-ordered table: pass (p, R) holds
    entries p - 1 .. p*R - 2, q-major, so a warp's neighbouring k read
    neighbouring entries."""
    return q * p + k - 1


def pass_twiddles(table, log2_m):
    """The pass-ordered table (m entries, the last one padding) gathered from
    the table of W_{2m}^j, j < m."""
    m = 1 << log2_m
    out = np.ones(m, dtype=table.dtype)
    p = 1
    for R in radix_plan(log2_m):
        for q in range(1, R):
            k = np.arange(p)
            out[twiddle_index(q, k, p)] = table_at(table, table_index(q, k, p, R, m), m)
        p *= R
    return out


def exchange_index(i, q, p, R):
    """Position of output q of butterfly i in a pass of radix R after p
    points' worth of earlier radices: (i / p) * p * R + (i mod p) + q * p."""
    k = i % p
    return (i - k) * R + k + q * p


def swizzle(a):
    """Shared-memory position of exchange position a: bits 0-3 XOR bits 5-8,
    bit 4 XOR bit 8.  A permutation inside each run of 32 positions."""
    return a ^ ((a >> 5) & 15) ^ (((a >> 8) & 1) << 4)


def w16(e: int, rounded: bool) -> complex:
    """W_16^e, in float64 or rounded to float32 (the kernel's literals)."""
    w = np.exp(-2j * np.pi * e / 16)
    return complex(np.complex64(w)) if rounded else complex(w)


def dft4(a, b, c, d):
    s0, d0, s1 = a + c, a - c, b + d
    d1 = -1j * (b - d)
    return [s0 + s1, d0 + d1, s0 - s1, d0 - d1]


def dft(u, rounded):
    """The kernel's radix-R DFT of the R points u (natural order out)."""
    R = len(u)
    if R == 2:
        return [u[0] + u[1], u[0] - u[1]]
    if R == 4:
        return dft4(*u)
    if R == 8:   # n = na + 2 nb, k = kb + 4 ka
        y0 = dft4(u[0], u[2], u[4], u[6])
        y1 = [w16(2 * kb, rounded) * y for kb, y in enumerate(dft4(u[1], u[3], u[5], u[7]))]
        return [y0[kb] + y1[kb] for kb in range(4)] + [y0[kb] - y1[kb] for kb in range(4)]
    assert R == 16   # n = na + 4 nb, k = kb + 4 ka
    y = [dft4(u[na], u[na + 4], u[na + 8], u[na + 12]) for na in range(4)]
    y = [[w16(na * kb, rounded) * y[na][kb] for kb in range(4)] for na in range(4)]
    cols = [dft4(y[0][kb], y[1][kb], y[2][kb], y[3][kb]) for kb in range(4)]
    return [cols[kb][ka] for ka in range(4) for kb in range(4)]


def stockham_fft(z: np.ndarray, table: np.ndarray, rounded: bool = False,
                 trace: list = None, drain=None) -> np.ndarray:
    """The kernel's schedule on m = len(z) points; ``table`` holds W_{2m}^j,
    j < m, and is read in pass order (:func:`pass_twiddles`).  ``trace``
    collects, per exchange, the write and read positions of each (slot,
    thread) for the bank and permutation checks.  ``drain(v)`` takes the
    registers (``v[s][t]``: slot s of thread t) as the kernel's Store does;
    by default Z in natural order (``SplitStore``)."""
    m = len(z)
    log2_m = m.bit_length() - 1
    T, P = thread_count(log2_m), points_per_thread(log2_m)
    t = np.arange(T)
    v = [z[slot_index(t, s, T)].astype(np.complex128) for s in range(P)]
    plan = radix_plan(log2_m)
    twiddles = pass_twiddles(table, log2_m)
    p = 1
    for n, R in enumerate(plan):
        nb = P // R
        for b in range(nb):
            i = t + b * T
            k = i % p
            u = [v[b + nb * q] for q in range(R)]
            if p > 1:
                u = [u[0]] + [u[q] * twiddles[twiddle_index(q, k, p)] for q in range(1, R)]
            for q, x in enumerate(dft(u, rounded)):
                v[b + nb * q] = x
        if n + 1 < len(plan):   # exchange through shared memory
            shared = np.full(m, np.nan, dtype=np.complex128)
            writes = {}
            for b in range(nb):
                i = t + b * T
                for q in range(R):
                    a = swizzle(exchange_index(i, q, p, R))
                    shared[a] = v[b + nb * q]
                    writes[(b, q)] = a
            reads = {s: swizzle(slot_index(t, s, T)) for s in range(P)}
            v = [shared[reads[s]] for s in range(P)]
            if trace is not None:
                trace.append((writes, reads))
        p *= R
    if drain is not None:
        return drain(v)
    out = np.full(m, np.nan, dtype=np.complex128)
    for s in range(P):
        out[slot_index(t, s, T)] = v[s]
    return out


def table64(m):
    return np.exp(-2j * np.pi * np.arange(m) / (2 * m))


def table32(m):
    c, s = stft_ops.unpack_twiddles(2 * m)
    return c.astype(np.float64) + 1j * s.astype(np.float64)


def random_points(m, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(m) + 1j * rng.standard_normal(m)


def test_radix_plan_of_the_production_and_small_sizes():
    assert radix_plan(14) == [16, 16, 16, 4]     # n_fft 32768: 3 exchanges
    assert radix_plan(10) == [16, 16, 4]
    assert radix_plan(11) == [16, 16, 8]
    assert radix_plan(4) == [16] and radix_plan(1) == [2]
    for log2_m in LOG2_M:
        plan = radix_plan(log2_m)
        assert int(np.prod(plan)) == 1 << log2_m
        assert len(plan) - 1 <= 4
        assert thread_count(log2_m) * points_per_thread(log2_m) == 1 << log2_m
        assert thread_count(log2_m) <= 1024


@pytest.mark.parametrize("log2_m", LOG2_M)
def test_the_ports_pass_twiddles_are_the_f32_table_rearranged(log2_m):
    """stft_ops.stockham_twiddles, which K6 reads, holds bit for bit the
    values of the f32 W_{2m}^j table at table_index, at twiddle_index; every
    entry but the padding is written once."""
    m = 1 << log2_m
    assert stft_ops.stockham_radices(m) == radix_plan(log2_m)
    c, s = stft_ops.stockham_twiddles(2 * m)
    want = pass_twiddles(table32(m).astype(np.complex64), log2_m)
    np.testing.assert_array_equal(c, want.real)
    np.testing.assert_array_equal(s, want.imag)
    seen = np.zeros(m, dtype=int)
    p = 1
    for R in radix_plan(log2_m):
        for q in range(1, R):
            np.add.at(seen, twiddle_index(q, np.arange(p), p), 1)
        p *= R
    assert (seen[:-1] == 1).all() and seen[-1] == 0


@pytest.mark.parametrize("log2_m", LOG2_M)
def test_schedule_in_float64_matches_numpy_fft(log2_m):
    m = 1 << log2_m
    z = random_points(m, seed=log2_m)
    got = stockham_fft(z, table64(m))
    want = np.fft.fft(z)
    assert not np.isnan(got).any()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("log2_m", LOG2_M)
def test_schedule_with_the_f32_twiddle_table(log2_m):
    """The table K6 reads (float64 rounded once to f32) and the f32 W_16
    literals: within 1e-6 of the peak (float64 arithmetic)."""
    m = 1 << log2_m
    z = random_points(m, seed=100 + log2_m)
    got = stockham_fft(z, table32(m), rounded=True)
    want = np.fft.fft(z)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("log2_m", LOG2_M)
def test_exchanges_are_permutations_free_of_bank_conflicts(log2_m):
    """Each exchange writes every position once; every warp-wide write and
    read (one slot of 32 neighbouring threads, 4-byte re or im words) hits
    32 distinct banks, or as many as the warp has threads."""
    m = 1 << log2_m
    trace = []
    stockham_fft(random_points(m, 7), table64(m), trace=trace)
    assert len(trace) == len(radix_plan(log2_m)) - 1
    T = thread_count(log2_m)
    for writes, reads in trace:
        written = np.concatenate(list(writes.values()))
        assert np.array_equal(np.sort(written), np.arange(m))
        for positions in (*writes.values(), *reads.values()):
            for w in range(0, T, WARP):
                lanes = positions[w:w + WARP]
                assert len(np.unique(lanes % BANKS)) == len(lanes)


def k6_frame_points(y, window, start, m):
    """The kernel's loader: packed point j of the frame starting at raw
    sample ``start``, windowed, read only where the window is non-zero;
    interior frames index directly, the others reflect on the index."""
    n = len(y)
    a = np.arange(2 * m)
    idx = start + a
    if not (start >= 0 and start + 2 * m <= n):
        if n == 1:
            idx = np.zeros_like(idx)
        else:
            period = 2 * (n - 1)
            idx = idx % period
            idx = np.where(idx < n, idx, period - idx)
    x = np.where(window != 0, y[np.clip(idx, 0, n - 1)], 0.0) * window
    return x[0::2] + 1j * x[1::2]


@pytest.mark.parametrize("n_fft,n", [(4, 3 * 4 + 11), (4, 1), (64, 3 * 64 + 11), (64, 7),
                                     (2048, 3 * 2048 + 11), (2048, 700)])
def test_model_of_k6_matches_the_plain_version(n_fft, n):
    """Framing, window, packing and the schedule against
    ``wave_packed_fft_plain`` in float64, on 3 signals of an odd length."""
    m, hop = n_fft // 2, max(1, 3 * n_fft // 8)
    window = stft_ops.padded_window(n_fft - n_fft // 8, n_fft).astype(np.float64)
    rng = np.random.default_rng(n_fft + n)
    waves = rng.standard_normal((3, n))
    n_frames = 1 + n // hop
    table = table64(m)
    got = np.array([[stockham_fft(k6_frame_points(y, window, f * hop - m, m), table)
                     for f in range(n_frames)] for y in waves])
    wr, wi = kernels.wave_packed_fft_plain(torch.from_numpy(waves),
                                           torch.from_numpy(window), hop, n_fft)
    want = wr.numpy() + 1j * wi.numpy()
    assert got.shape == want.shape == (3, n_frames, m)
    peak = np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(got - want) <= 1e-12 * np.maximum(peak, 1e-300)).all()


# ---------------------------------------------------------------------------
# K3: the power drain (PowerStore) and the whole kernel
# ---------------------------------------------------------------------------

def drain_partner(t, s, T, P):
    """Thread and slot holding Z[(m - k) mod m] for bin k = t + T*s: for
    t > 0 thread T - t, slot P - 1 - s; for t = 0 thread 0, slot (P - s) mod P."""
    t = np.asarray(t)
    return np.where(t == 0, 0, T - t), np.where(t == 0, (P - s) % P, P - 1 - s)


def drain_write_index(t, s, T):
    """Where the drain writes slot s of thread t: its bin, natural order."""
    return slot_index(t, s, T)


def drain_read_index(t, s, T, m):
    """Where the drain reads the mirror of slot s of thread t: bin (m - k) mod m."""
    return (m - slot_index(t, s, T)) % m


def power_drain(v, unpack, trace=None):
    """PowerStore on the registers ``v`` (P slots of T threads): the one-sided
    power |X[k]|^2, k = 0..m, of the packed spectrum.  ``unpack`` holds
    W_N^k, k < m.  One thread takes the mirrors from its own slots; more go
    through the exchange (``trace`` collects its writes and reads)."""
    P, T = len(v), len(v[0])
    m = T * P
    t = np.arange(T)
    if T == 1:
        mirror = [v[(P - s) % P] for s in range(P)]
    else:
        shared = np.full(m, np.nan, dtype=np.complex128)
        writes = {s: drain_write_index(t, s, T) for s in range(P)}
        for s in range(P):
            shared[writes[s]] = v[s]
        reads = {s: drain_read_index(t, s, T, m) for s in range(P)}
        mirror = [shared[reads[s]] for s in range(P)]
        if trace is not None:
            trace.append((writes, reads))
    row = np.full(m + 1, np.nan)
    for s in range(P):
        k = slot_index(t, s, T)
        zk, zr = v[s], np.conj(mirror[s])
        x = (zk + zr) / 2 + unpack[k] * (zk - zr) / 2j      # E[k] + W_N^k O[k]
        row[k] = x.real ** 2 + x.imag ** 2
    row[m] = (v[0][0].real - v[0][0].imag) ** 2            # X[m] = E[0] - O[0]
    return row


def k3_row_points(row, window):
    """PackedRowLoad: packed point j = (w[2j] x[2j], w[2j+1] x[2j+1]) of a
    pre-framed row, zero (and the sample not read) where the window is zero."""
    x = np.where(window != 0, row, 0.0) * window
    return x[0::2] + 1j * x[1::2]


def k3_model(rows, window):
    """The whole of K3 on (rows, n_fft) samples in float64: int16 rows with
    the window pre-scaled by 1/32768 (as the wrapper does), fill, schedule,
    drain.  Returns (rows, n_fft/2 + 1) power."""
    if rows.dtype == np.int16:
        window = window / 32768.0
    m = rows.shape[1] // 2
    table = table64(m)
    return np.array([stockham_fft(k3_row_points(r.astype(np.float64), window), table,
                                  drain=lambda v: power_drain(v, table)) for r in rows])


@pytest.mark.parametrize("log2_m", LOG2_M)
def test_drain_partner_holds_the_mirror_bin(log2_m):
    """The partner slot holds bin (m - k) mod m, and the drain's read of slot
    s of thread t is where that partner wrote."""
    m, T, P = 1 << log2_m, thread_count(log2_m), points_per_thread(log2_m)
    t = np.arange(T)
    for s in range(P):
        pt, ps = drain_partner(t, s, T, P)
        assert ((0 <= pt) & (pt < T) & (0 <= ps) & (ps < P)).all()
        assert np.array_equal(slot_index(pt, ps, T), (m - slot_index(t, s, T)) % m)
        assert np.array_equal(drain_write_index(pt, ps, T), drain_read_index(t, s, T, m))


@pytest.mark.parametrize("log2_m", LOG2_M)
def test_drain_exchange_is_a_permutation_free_of_bank_conflicts(log2_m):
    """The drain's exchange writes and reads every position once, and every
    warp-wide write and read hits as many banks as the warp has threads.  One
    thread (m <= 16) needs no exchange.  Under the Stockham exchanges'
    swizzle a warp's mirrored reads would cover 31 positions of one run and 1
    of the next, two on one bank: hence natural order."""
    m, T = 1 << log2_m, thread_count(log2_m)
    trace = []
    stockham_fft(random_points(m, 11), table64(m),
                 drain=lambda v: power_drain(v, table64(m), trace))
    assert len(trace) == (0 if T == 1 else 1)
    for writes, reads in trace:
        for positions in (writes, reads):
            assert np.array_equal(np.sort(np.concatenate(list(positions.values()))),
                                  np.arange(m))
            for lanes_of_slot in positions.values():
                for w in range(0, T, WARP):
                    lanes = lanes_of_slot[w:w + WARP]
                    assert len(np.unique(lanes % BANKS)) == len(lanes)
        if T >= WARP:
            swizzled = swizzle(reads[0][:WARP]) % BANKS
            assert len(np.unique(swizzled)) == WARP - 1


@pytest.mark.parametrize("log2_m", LOG2_M)
def test_power_drain_matches_numpy_rfft(log2_m):
    """Schedule then drain on a random real row of n_fft = 2m samples: its
    one-sided power within 1e-12 of the peak of |np.fft.rfft|^2."""
    m = 1 << log2_m
    x = np.random.default_rng(200 + log2_m).standard_normal(2 * m)
    got = stockham_fft(x[0::2] + 1j * x[1::2], table64(m),
                       drain=lambda v: power_drain(v, table64(m)))
    want = np.abs(np.fft.rfft(x)) ** 2
    assert got.shape == want.shape == (m + 1,)
    assert np.abs(got - want).max() <= 1e-12 * want.max()


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("n_fft", [4, 16, 64, 512, 2048, 32768])
def test_model_of_k3_matches_the_plain_version(n_fft, dtype):
    """Fill, schedule and drain against ``frames_stft_power_plain`` in
    float64 on 4 rows (one silent: exactly 0), within 1e-12 of each row's
    peak; float32 rows hold NaN where the window is zero, which the fill
    never reads."""
    window = stft_ops.padded_window(n_fft - n_fft // 8, n_fft).copy()
    rng = np.random.default_rng(n_fft)
    x = np.clip(0.3 * rng.standard_normal((4, n_fft))
                + 0.5 * np.sin(0.3 * np.arange(n_fft)), -1, 1).astype(np.float32)
    x[2] = 0.0
    rows = (x * 32767).round().astype(np.int16) if dtype == "int16" else x
    want = kernels.frames_stft_power_plain(torch.from_numpy(rows), torch.from_numpy(window),
                                           n_fft, dtype=torch.float64).numpy()
    if dtype == "float32":
        rows = np.where(window != 0, rows, np.nan).astype(np.float32)
    got = k3_model(rows, window.astype(np.float64))
    assert got.shape == want.shape == (4, n_fft // 2 + 1)
    peak = want.max(axis=-1, keepdims=True)
    assert (np.abs(got - want) <= 1e-12 * np.maximum(peak, 1e-300)).all()
    assert (got[2] == 0.0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
@pytest.mark.parametrize("offset", [0, 1])
def test_k3_rows_reach_the_kernel_aligned_to_a_pair_of_samples(offset, dtype):
    """PackedRowLoad reads samples 2j and 2j + 1 as one load, so the wrapper
    hands K3 rows whose base is aligned to a pair: an aligned view as it is,
    a contiguous view at an odd element offset as an aligned copy."""
    rows, n_fft = 3, 16
    flat = torch.arange(rows * n_fft + 1).to(dtype)
    view = flat[offset:offset + rows * n_fft].view(rows, n_fft)
    assert view.is_contiguous()
    got = kernels._pair_aligned(view)
    assert got.data_ptr() % (2 * got.element_size()) == 0
    assert (got.data_ptr() == view.data_ptr()) == (offset == 0)
    assert got.is_contiguous() and torch.equal(got, view)


# ---------------------------------------------------------------------------
# K1 and K5: K6's loader, the schedule and K3's drain; K5's band epilogue
# ---------------------------------------------------------------------------

def k1_model(waves, window, hop, n_fft):
    """The whole of K1 in float64: each centred frame through K6's loader,
    the schedule and the power drain.  Returns (n_sig, n_frames, m + 1)."""
    m = n_fft // 2
    table = table64(m)
    return np.array([[stockham_fft(k6_frame_points(y, window, f * hop - m, m), table,
                                   drain=lambda v: power_drain(v, table))
                      for f in range(1 + len(y) // hop)] for y in waves])


@pytest.mark.parametrize("n_fft,n", [(4, 3 * 4 + 11), (4, 1), (64, 3 * 64 + 11), (64, 7),
                                     (2048, 3 * 2048 + 11), (2048, 700)])
def test_model_of_k1_matches_the_plain_version(n_fft, n):
    """Loader, schedule and drain against ``wave_stft_power_plain`` in
    float64 on 3 signals of an odd length: interior frames, frames over both
    reflection edges, and signals shorter than a frame (reflected again and
    again; one sample), within 1e-12 of each frame's peak."""
    hop = max(1, 3 * n_fft // 8)
    window = stft_ops.padded_window(n_fft - n_fft // 8, n_fft).astype(np.float64)
    waves = np.random.default_rng(n_fft + n).standard_normal((3, n))
    got = k1_model(waves, window, hop, n_fft)
    want = kernels.wave_stft_power_plain(torch.from_numpy(waves), torch.from_numpy(window),
                                         hop, n_fft).numpy()
    assert got.shape == want.shape == (3, 1 + n // hop, n_fft // 2 + 1)
    peak = want.max(axis=-1, keepdims=True)
    assert (np.abs(got - want) <= 1e-12 * np.maximum(peak, 1e-300)).all()


def fmaf32(a, b, c):
    """fmaf in float32: the product of two floats is exact in float64, then
    one rounding of the sum (the same emulation in every order below)."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


SEG = kernels.MEL_SEGMENT_BINS   # kSegBins
# (kMelChunk<R>, kMelSlots<R>): bins of one row a K2 copy brings, and chunks
# in a row's ring, one row at a time and kMelRows = 4 at a time.
RINGS = {1: (1024, 16), 4: (2048, 4)}
CONFIGS = {"SMALL": dict(working_sample_rate=8000, time_margin=0.33), "PROD": {}}


def bands_of(cfg_kwargs):
    """(fb, lo, hi, offset, weights, segments, band_first, work) of a config."""
    from sed_tpu_torch.configs import SpectrogramConfig
    from sed_tpu_torch.ops.mel import mel_filterbank

    fb = mel_filterbank(SpectrogramConfig(**cfg_kwargs), dtype=np.float32)
    lo, hi, off, weights = kernels.mel_bands_numpy(fb)
    return (fb, lo, hi, off, weights) + kernels.mel_segments_numpy(lo, hi, off)


def bands_at(n_fft):
    """The 64-band Slaney filterbank of n_fft at 8 kHz, as the gpu tests'
    ``bands_at`` builds it (below n_fft ~ 256 many bands cover no bin)."""
    return dict(working_sample_rate=8000, time_margin=n_fft / 16000)


TABLES = [*CONFIGS] + [f"n_fft={1 << k}" for k in range(2, 16)]


def table_config(name):
    return CONFIGS[name] if name in CONFIGS else bands_at(int(name.split("=")[1]))


def lane_sums(p, w, first, bins):
    """The 32 lane sums of one segment, as segment_sums' lanes and
    segment_sum_by_thread build them: lane l adds bins first + l,
    first + l + 32, ... of the segment by fmaf, from 0, in that order; ``w``
    holds the segment's weights."""
    acc = [np.float32(0.0)] * WARP
    for k in range(bins):
        acc[k % WARP] = fmaf32(p[first + k], w[k], acc[k % WARP])
    return np.array(acc, dtype=np.float32)


def warp_shuffle_sum(acc):
    """segment_sums' tree: acc += __shfl_down_sync(acc, o) for o = 16, 8, 4,
    2, 1 on all 32 lanes at once, a lane whose source is past lane 31 reading
    its own value; lane 0 holds the segment's sum."""
    for o in (16, 8, 4, 2, 1):
        src = np.arange(WARP) + o
        acc = acc + np.where(src < WARP, acc[np.minimum(src, WARP - 1)], acc)
    return acc[0]


def by_thread_sum(acc):
    """K5 below 32 threads (segment_sum_by_thread): one thread adds
    sum[l] += sum[l + o] for l < o, o = 16, 8, 4, 2, 1, in place."""
    acc = list(acc)
    for o in (16, 8, 4, 2, 1):
        for lane in range(o):
            acc[lane] = np.float32(acc[lane] + acc[lane + o])
    return acc[0]


def band_sum(p, weights, segments, band_first, b, tree=warp_shuffle_sum):
    """band_sum: 0, plus band b's segment sums left to right, each segment
    summed by ``tree`` over its lane sums."""
    s = np.float32(0.0)
    for first, bins, woff, _ in segments[band_first[b]:band_first[b + 1]]:
        seg = tree(lane_sums(p, weights[woff:woff + bins], first, bins))
        s = np.float32(s + seg)
    return s


def seeded_power(n_bins):
    return (np.random.default_rng(n_bins).random(n_bins) ** 4 * 1e3).astype(np.float32)


@pytest.mark.parametrize("name", TABLES)
def test_segments_cover_each_band_once_in_order(name):
    """mel_segments_numpy cuts each band's range [lo, hi) into runs of SEG
    bins from lo, the last one shorter: the segments of band b, in
    band_first's order, tile its range exactly once, left to right, with the
    weight offsets of those bins; an empty band has none.  ``work`` is every
    segment once, by last bin."""
    fb, lo, hi, off, weights, segments, band_first, work = bands_of(table_config(name))
    n_mels = fb.shape[1]
    assert segments.dtype == band_first.dtype == work.dtype == np.int32
    assert segments.shape[1] == 4 and band_first.shape == (n_mels + 1,)
    assert band_first[0] == 0 and band_first[-1] == len(segments)
    assert (np.diff(band_first) >= 0).all()
    for b in range(n_mels):
        own = segments[band_first[b]:band_first[b + 1]]
        assert (own[:, 3] == b).all()
        covered = np.concatenate([np.arange(f, f + n) for f, n, _, _ in own] or [[]])
        assert np.array_equal(covered, np.arange(lo[b], hi[b]))
        assert (own[:, 1] >= 1).all() and (own[:-1, 1] == SEG).all() and (own[:, 1] <= SEG).all()
        assert np.array_equal(own[:, 2], off[b] + own[:, 0] - lo[b])
    assert np.array_equal(np.sort(work), np.arange(len(segments)))
    assert (np.diff(segments[work, 0] + segments[work, 1]) >= 0).all()
    if name == "PROD":
        assert len(segments) == 156


@pytest.mark.parametrize("name", list(CONFIGS))
def test_k5_band_sums_by_thread_equal_the_warps_bit_for_bit(name):
    """K5's epilogue for fewer than 32 threads adds each band in K2's order:
    for every band of the config's filterbank, on seeded float32 power, the
    one-thread trees over the band's segments equal the warps' shuffle trees
    bit for bit (and both are the band's sum within float32 rounding).  A
    plain left-to-right sum differs from it in some band: the order is what
    the equality rests on."""
    fb, lo, hi, off, weights, segments, band_first, _ = bands_of(CONFIGS[name])
    p = seeded_power(fb.shape[0])
    differs = 0
    for b in range(fb.shape[1]):
        warp = band_sum(p, weights, segments, band_first, b)
        thread = band_sum(p, weights, segments, band_first, b, tree=by_thread_sum)
        assert np.float32(warp).view(np.int32) == np.float32(thread).view(np.int32), b
        w = weights[off[b]:off[b] + hi[b] - lo[b]]
        exact = float(np.dot(p[lo[b]:hi[b]].astype(np.float64), w.astype(np.float64)))
        assert abs(float(warp) - exact) <= 1e-5 * exact
        seq = np.float32(0.0)
        for k in range(lo[b], hi[b]):
            seq = fmaf32(p[k], w[k - lo[b]], seq)
        differs += int(seq != warp)
    assert differs > 0


@pytest.mark.parametrize("name", list(CONFIGS))
def test_segment_order_is_the_one_warp_order_for_bands_no_wider_than_a_segment(name):
    """A band of at most SEG bins is one segment, and its sum is bit for bit one
    warp's lane sums over the whole band, then the shuffle tree.  About half of
    the production bands are such bands; the wider ones stay within float32
    rounding of the exact sum."""
    fb, lo, hi, off, weights, segments, band_first, _ = bands_of(CONFIGS[name])
    p = seeded_power(fb.shape[0])
    narrow = 0
    for b in range(fb.shape[1]):
        w = weights[off[b]:off[b] + hi[b] - lo[b]]
        one_warp = warp_shuffle_sum(lane_sums(p, w, lo[b], hi[b] - lo[b]))
        got = band_sum(p, weights, segments, band_first, b)
        if hi[b] - lo[b] <= SEG:
            narrow += 1
            assert np.float32(got).view(np.int32) == np.float32(one_warp).view(np.int32), b
        exact = float(np.dot(p[lo[b]:hi[b]].astype(np.float64), w.astype(np.float64)))
        assert abs(float(got) - exact) <= 1e-5 * exact
    assert narrow == {"SMALL": 60, "PROD": 32}[name]


# ---------------------------------------------------------------------------
# K2's ring: which bins each chunk copy brings, and when each segment is summed
# ---------------------------------------------------------------------------

def span_of(lo, hi):
    covered = hi > lo
    return (int(lo[covered].min()), int(hi[covered].max())) if covered.any() else (0, 0)


def chunk_count(span_lo, span_hi, chunk):
    """Chunks of a row: its span read from up to 3 bins before span_lo."""
    return (span_hi - span_lo + 2) // chunk + 1 if span_hi > span_lo else 0


def mel_chunk(g0, k, chunk, span_lo, span_hi):
    """MelChunk: chunk k of a row read from g0 (the 16-byte boundary at or
    before span_lo): its bins (s, e) inside the span, its bulk-copied middle
    [bs, be), its scalar head [s, he) and tail [ts, e)."""
    ha = span_lo if g0 == span_lo else g0 + 4
    ta = g0 + ((span_hi - g0) & ~3)
    s, e = max(g0 + k * chunk, span_lo), min(g0 + (k + 1) * chunk, span_hi)
    return dict(s=s, e=e, bs=max(s, ha), be=min(e, ta), he=min(e, ha), ts=max(s, ha, ta))


def segment_step(first, bins, span_lo, chunk):
    """The step (chunk) at which K2's warps sum a segment: the chunk of its
    last bin in the worst alignment (g0 = span_lo - 3)."""
    return (first + bins - 1 - span_lo + 3) // chunk


@pytest.mark.parametrize("rows_at_once", sorted(RINGS))
@pytest.mark.parametrize("sh", range(4))
@pytest.mark.parametrize("name", TABLES + ["n_bins=65537"])
def test_k2_chunks_read_each_bin_of_the_span_once(name, sh, rows_at_once):
    """For a row whose span starts sh floats past a 16-byte boundary, the
    chunks' bulk copies and scalar loads read every bin of the span
    [span_lo, span_hi) exactly once and nothing outside it (the last row of
    an allocation is read up to its last bin, not past it); each bulk copy
    starts on a 16-byte boundary and moves a multiple of 16 bytes; each
    scalar head and tail is at most 4 bins (lanes 0-3, 4-7)."""
    cfg = dict(time_margin=0.7) if name == "n_bins=65537" else table_config(name)
    fb, lo, hi, *_ = bands_of(cfg)
    span_lo, span_hi = span_of(lo, hi)
    assert span_hi <= fb.shape[0]
    row0 = 4 * 1000 + sh - span_lo % 4       # the row's first bin, in floats from a boundary
    g0 = span_lo - (row0 + span_lo) % 4
    assert (row0 + g0) % 4 == 0 and span_lo - g0 == sh
    chunk = RINGS[rows_at_once][0]
    reads = np.zeros(fb.shape[0] + 8, dtype=int)
    for k in range(chunk_count(span_lo, span_hi, chunk)):
        c = mel_chunk(g0, k, chunk, span_lo, span_hi)
        if c["be"] > c["bs"]:
            assert (row0 + c["bs"]) % 4 == 0 and (c["be"] - c["bs"]) % 4 == 0
            reads[c["bs"]:c["be"]] += 1
        assert c["he"] - c["s"] <= 4 and c["e"] - c["ts"] <= 4
        reads[c["s"]:max(c["s"], c["he"])] += 1
        reads[c["ts"]:max(c["ts"], c["e"])] += 1
    assert (reads[span_lo:span_hi] == 1).all()
    assert reads[:span_lo].sum() == reads[span_hi:].sum() == 0


@pytest.mark.parametrize("rows_at_once", sorted(RINGS))
@pytest.mark.parametrize("name", TABLES + ["n_bins=65537"])
def test_k2_segments_find_their_bins_in_the_ring(name, rows_at_once):
    """At its step k a segment's bins lie in chunks k - 1 and k of every row
    alignment (the ones the warps still hold), chunk k is the last the
    segment needs, and their ring positions ((base + x) mod slots * chunk)
    are distinct; the warps' order (``work``) never goes back a step."""
    cfg = dict(time_margin=0.7) if name == "n_bins=65537" else table_config(name)
    fb, lo, hi, off, weights, segments, band_first, work = bands_of(cfg)
    span_lo, span_hi = span_of(lo, hi)
    chunk, slots = RINGS[rows_at_once]
    chunks = chunk_count(span_lo, span_hi, chunk)
    steps = [segment_step(f, n, span_lo, chunk) for f, n, _, _ in segments]
    assert all(0 <= k < chunks for k in steps)
    assert (np.diff([steps[i] for i in work]) >= 0).all()
    for sh in range(4):
        g0 = span_lo - sh
        for seq0 in (0, 3, slots - 1):
            base = (seq0 % slots) * chunk - g0
            for (first, bins, _, _), k in zip(segments, steps):
                x = np.arange(first, first + bins)
                of = (x - g0) // chunk
                assert of.min() >= k - 1 and of.max() <= k, (first, bins, k)
                pos = (base + x) % (slots * chunk)
                assert len(np.unique(pos)) == bins
                assert ((pos // chunk) == (seq0 + of) % slots).all()


# ---------------------------------------------------------------------------
# The cluster FFT (n_fft 65536, 131072): a cross pass over C CTAs, then each
# CTA's stockham_fft on 2^14 points; the drain's mirrors across the cluster
# ---------------------------------------------------------------------------

CTA_POINTS = 1 << 14
CLUSTER_N_FFT = (65536, 131072)


def cross_pass(z, cross, r):
    """CrossLoad's output in CTA r: sum_q chunk_q W_C^(q r), q in order (W_C
    a power of -i, exact), times row r of the cross table (r > 0)."""
    C = len(z) // CTA_POINTS
    chunks = z.reshape(C, CTA_POINTS)
    acc = chunks[0].astype(np.complex128)
    for q in range(1, C):
        acc = acc + chunks[q] * (-1j) ** ((q * r * (4 // C)) % 4)
    return acc * cross[r] if r else acc


def cluster_fft(z, cross, table, drain=None):
    """The cluster's FFT of m = C * 2^14 points: CTA r's stockham_fft of its
    cross-pass output holds bins r + C k1 (k1 its natural order).  ``drain(r,
    v)`` takes CTA r's registers; by default Z in natural order."""
    m = len(z)
    C = m // CTA_POINTS
    regs = [stockham_fft(cross_pass(z, cross, r), table, drain=lambda v: v) for r in range(C)]
    if drain is not None:
        return [drain(r, v, regs) for r, v in enumerate(regs)]
    out = np.full(m, np.nan, dtype=np.complex128)
    T = thread_count(14)
    t = np.arange(T)
    for r, v in enumerate(regs):
        for s in range(POINTS):
            out[r + C * slot_index(t, s, T)] = v[s]
    return out


def cluster_partner(r, k1, C):
    """ClusterPowerStore: the CTA and the k1 that hold Z[(m - k) mod m] for
    bin k = r + C k1."""
    k1 = np.asarray(k1)
    if r == 0:
        return 0, (CTA_POINTS - k1) % CTA_POINTS
    return C - r, CTA_POINTS - 1 - k1


def cross64(m):
    C = m // CTA_POINTS
    return np.exp(-2j * np.pi * np.outer(np.arange(C), np.arange(CTA_POINTS)) / m)


def cross32(m):
    c, s = stft_ops.cluster_twiddles(2 * m)
    return c.astype(np.float64) + 1j * s.astype(np.float64)


@pytest.mark.parametrize("n_fft", CLUSTER_N_FFT)
def test_cluster_tables_are_the_f32_rounding_of_float64(n_fft):
    """The cross table is W_m^(r n1) rounded once to f32, after the 2^14
    pass-ordered twiddles of a CTA's FFT in the table the kernels read."""
    m = n_fft // 2
    c, s = stft_ops.cluster_twiddles(n_fft)
    want = cross64(m)
    assert np.array_equal(c, want.real.astype(np.float32))
    assert np.array_equal(s, want.imag.astype(np.float32))
    table = kernels._stockham_twiddles(n_fft, torch.device("cpu")).numpy()
    sub = np.stack(stft_ops.stockham_twiddles(2 * CTA_POINTS), axis=1)
    assert table.shape == ((m // CTA_POINTS + 1) * CTA_POINTS, 2)
    assert np.array_equal(table[:CTA_POINTS], sub)
    assert np.array_equal(table[CTA_POINTS:, 0], c.reshape(-1))
    assert np.array_equal(table[CTA_POINTS:, 1], s.reshape(-1))


@pytest.mark.parametrize("n_fft", CLUSTER_N_FFT)
def test_cluster_fft_matches_numpy_fft(n_fft):
    """The cross pass, then each CTA's schedule, in float64 (exact tables)
    and with the f32 tables the kernels read."""
    m = n_fft // 2
    z = random_points(m, n_fft)
    want = np.fft.fft(z)
    got = cluster_fft(z, cross64(m), table64(CTA_POINTS))
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()
    got32 = cluster_fft(z, cross32(m), table32(CTA_POINTS))
    assert np.abs(got32 - want).max() <= 2e-6 * np.abs(want).max()


@pytest.mark.parametrize("n_fft", CLUSTER_N_FFT)
def test_cluster_partner_holds_the_mirror_bin(n_fft):
    """Bin k = r + C k1's mirror (m - k) mod m is bin partner + C k1', and
    the partner CTA's k1' covers every position once."""
    m = n_fft // 2
    C = m // CTA_POINTS
    k1 = np.arange(CTA_POINTS)
    for r in range(C):
        pr, pk = cluster_partner(r, k1, C)
        assert pr == (C - r) % C
        assert np.array_equal(pr + C * pk, (m - (r + C * k1)) % m)
        assert np.array_equal(np.sort(pk), k1)


def cluster_power_drain(z_regs, unpack, C):
    """ClusterPowerStore of every CTA, as one (m + 1,) row: CTA r's bins r +
    C k1, each with the mirror from its partner CTA."""
    m = C * CTA_POINTS
    T = thread_count(14)
    t = np.arange(T)
    shared = []
    for v in z_regs:
        buf = np.full(CTA_POINTS, np.nan, dtype=np.complex128)
        for s in range(POINTS):
            buf[slot_index(t, s, T)] = v[s]
        shared.append(buf)
    row = np.full(m + 1, np.nan)
    for r, v in enumerate(z_regs):
        for s in range(POINTS):
            k1 = slot_index(t, s, T)
            pr, pk = cluster_partner(r, k1, C)
            zk, zr = v[s], np.conj(shared[pr][pk])
            k = r + C * k1
            x = (zk + zr) / 2 + unpack[k] * (zk - zr) / 2j
            row[k] = x.real ** 2 + x.imag ** 2
    row[m] = (z_regs[0][0][0].real - z_regs[0][0][0].imag) ** 2
    return row


@pytest.mark.parametrize("n_fft", CLUSTER_N_FFT)
def test_model_of_cluster_k1_matches_the_plain_version(n_fft):
    """K1 over a cluster (each CTA's chunk of the centred frame by K6's
    loader, the cross pass, the schedule, the cluster drain) against
    ``wave_stft_power_plain`` in float64: an interior frame and the frames
    over both reflection edges of a signal of 2.5 frames."""
    m, hop = n_fft // 2, n_fft // 2
    C = m // CTA_POINTS
    window = stft_ops.padded_window(n_fft - n_fft // 8, n_fft).astype(np.float64)
    y = np.random.default_rng(n_fft).standard_normal(5 * n_fft // 4 + 3)
    n_frames = 1 + len(y) // hop
    unpack = table64(m)
    rows = np.array([cluster_power_drain(
        cluster_fft(k6_frame_points(y, window, f * hop - m, m), cross64(m), table64(CTA_POINTS),
                    drain=lambda r, v, regs: regs)[0], unpack, C) for f in range(n_frames)])
    want = kernels.wave_stft_power_plain(torch.from_numpy(y[None]), torch.from_numpy(window),
                                         hop, n_fft).numpy()[0]
    assert rows.shape == want.shape == (n_frames, m + 1)
    peak = want.max(axis=-1, keepdims=True)
    assert (np.abs(rows - want) <= 1e-9 * peak).all()
    # K5 reads bin k from CTA k mod C at k // C: the CTAs' rows rebuild it.
    k = np.arange(m + 1)
    per_cta = [np.append(rows[0][r:m:C], rows[0][m] if r == 0 else np.nan) for r in range(C)]
    assert np.array_equal(np.array([per_cta[kk % C][kk // C] for kk in k]), rows[0])


# ---------------------------------------------------------------------------
# Above n_fft 131072 (2^18, 2^19, 2^20): the global cross pass into R = 2, 4, 8
# sub-rows of 2^16 points (fft_cross_pass_kernel), each sub-row's cluster FFT
# (fft_subrows_kernel), and the unpack from the sub-rows' Z
# (packed_power_kernel)
# ---------------------------------------------------------------------------

SUB_POINTS = stft_ops.SUB_ROW_POINTS
WIDE_N_FFT = (262144, 524288, 1048576)


def rot(q):
    """W_4^q = (-i)^q, exact."""
    return (-1j) ** (q % 4)


def global_cross_pass(z, cross):
    """fft_cross_pass_kernel on one frame's m = R * 2^16 packed points ->
    (R, 2^16) sub-rows.  R = 2, 4: sub-row r = sum_q chunk_q W_R^(q r), q in
    order, times W_m^(n1 r) (``cross`` row r); R = 8: radix 4 over chunks of
    2M (n1' = n1 + M j), times W_m^(n1' r1), then radix 2 of each, times
    W_2M^(n1 r2), to sub-row r1 + 4 r2."""
    m, M = len(z), SUB_POINTS
    R = m // M
    chunks = z.reshape(R, M).astype(np.complex128)
    out = np.empty((R, M), np.complex128)
    if R <= 4:
        for r in range(R):
            acc = chunks[0].copy()
            for q in range(1, R):
                acc = acc + chunks[q] * rot(q * r * (4 // R))
            out[r] = acc * cross[r] if r else acc
        return out
    table, last = cross
    y = np.empty((4, 2, M), np.complex128)
    for j in range(2):
        for r1 in range(4):
            acc = chunks[j].copy()
            for q1 in range(1, 4):
                acc = acc + chunks[j + 2 * q1] * rot(q1 * r1)
            y[r1, j] = acc * table[r1, M * j: M * (j + 1)] if r1 else acc
    for r1 in range(4):
        out[r1] = y[r1, 0] + y[r1, 1]
        out[r1 + 4] = (y[r1, 0] - y[r1, 1]) * last
    return out


def cross_tables64(m):
    """The cross pass's tables in float64: (R, M) rows of W_m^(r n1); at R = 8
    the (4, 2M) rows of W_m^(r1 n1') and the M entries of W_2M^n1."""
    R, M = m // SUB_POINTS, SUB_POINTS
    radix = min(R, 4)
    table = np.exp(-2j * np.pi * np.outer(np.arange(radix), np.arange(m // radix)) / m)
    return table if R <= 4 else (table, np.exp(-2j * np.pi * np.arange(M) / (2 * M)))


def cross_tables32(n_fft):
    """The same from ``stft_ops.cross_pass_twiddles``, the f32 table the
    kernel reads."""
    m = n_fft // 2
    c, s = stft_ops.cross_pass_twiddles(n_fft)
    flat = c.astype(np.float64) + 1j * s.astype(np.float64)
    R, M = m // SUB_POINTS, SUB_POINTS
    radix = min(R, 4)
    table = flat[: m].reshape(radix, m // radix)
    return table if R <= 4 else (table, flat[m:])


def subrow_bins(sub, fft=np.fft.fft):
    """Z of the frame from its sub-rows' FFTs: Z[s + R k] = FFT(sub-row s)[k]
    (fft_subrows_kernel's natural store, stride R)."""
    R, M = sub.shape
    z = np.empty(R * M, np.complex128)
    for s in range(R):
        z[s::R] = fft(sub[s])
    return z


def inplace_store(fft_rows):
    """fft_subrows_kernel's in-place store of each sub-row's FFT (natural
    bins q of (R, M)): CTA r's bins r + 4 k1 at r 2^14 + k1 of the row."""
    R, M = fft_rows.shape
    return fft_rows.reshape(R, M // 4, 4).transpose(0, 2, 1).reshape(R, M)


def stored_at(stored, j):
    """Where packed_power_kernel reads Z[j] of a frame: sub-row s = j mod R,
    its bin q = j // R at (q mod 4) 2^14 + q // 4."""
    R, M = stored.shape
    q = j // R
    return stored[j % R, (q % 4) * (M // 4) + q // 4]


def packed_power(stored, unpack):
    """packed_power_kernel on one frame: the sub-rows' Z as fft_subrows_kernel
    stored it -> (m + 1,) power, Z[k] read at sub-row k mod R and its mirror
    Z[(m - k) mod m] at sub-row (R - k mod R) mod R."""
    R, M = stored.shape
    m = R * M
    k = np.arange(m)
    zk = stored_at(stored, k)
    mk = (m - k) % m
    zm = np.conj(stored_at(stored, mk))
    x = (zk + zm) / 2 + unpack * (zk - zm) / 2j
    return np.append(x.real ** 2 + x.imag ** 2, (zk[0].real - zk[0].imag) ** 2)


def test_cross_pass_tables_are_the_f32_rounding_of_float64():
    for n_fft in WIDE_N_FFT:
        m = n_fft // 2
        c, s = stft_ops.cross_pass_twiddles(n_fft)
        want = cross_tables64(m)
        flat = np.concatenate([np.ravel(a) for a in (want if isinstance(want, tuple) else (want,))])
        assert c.shape == (m if m // SUB_POINTS <= 4 else m + SUB_POINTS,)
        assert np.array_equal(c, flat.real.astype(np.float32))
        assert np.array_equal(s, flat.imag.astype(np.float32))
        assert np.array_equal(kernels._cross_twiddles(n_fft, torch.device("cpu")).numpy(),
                              np.stack([c, s], axis=1))


@pytest.mark.parametrize("n_fft", WIDE_N_FFT)
def test_global_cross_pass_then_subrow_ffts_match_numpy_fft(n_fft):
    """R = 2, 4 and 4 then 2: the cross pass and each sub-row's FFT give the
    frame's FFT, in float64 (exact tables) and with the f32 table."""
    m = n_fft // 2
    z = random_points(m, n_fft)
    want = np.fft.fft(z)
    got = subrow_bins(global_cross_pass(z, cross_tables64(m)))
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()
    got32 = subrow_bins(global_cross_pass(z, cross_tables32(n_fft)))
    assert np.abs(got32 - want).max() <= 2e-6 * np.abs(want).max()


def test_subrows_are_the_n_fft_131072_cluster_fft():
    """Each sub-row is the 2^16-point FFT of K1 at n_fft 131072: the cluster
    FFT's model (cross pass over 4 CTAs, then their schedules) on the
    sub-rows of a frame at n_fft 2^18."""
    m = 1 << 17
    sub = global_cross_pass(random_points(m, 3), cross_tables64(m))
    got = subrow_bins(sub, lambda x: cluster_fft(x, cross64(SUB_POINTS), table64(CTA_POINTS)))
    want = subrow_bins(sub)
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()


@pytest.mark.parametrize("n_fft", WIDE_N_FFT)
def test_packed_power_reads_each_bin_and_its_mirror_sub_row(n_fft):
    """The unpack's reads: bin k at sub-row k mod R, its mirror at sub-row
    (R - k mod R) mod R (R = 4: sub-rows 1 and 3 need each other, so no
    sub-row's launch unit could finish its power alone), each (sub-row,
    column) read once as a bin and once as a mirror."""
    m = n_fft // 2
    R = m // SUB_POINTS
    k = np.arange(m)
    mk = (m - k) % m
    assert np.array_equal(mk % R, (R - k % R) % R)
    assert np.array_equal(np.sort(mk % R * SUB_POINTS + mk // R), k)
    # Each stored position holds one bin: the in-place order is a permutation.
    pos = np.arange(SUB_POINTS)
    assert np.array_equal(np.sort(inplace_store(np.tile(pos, (R, 1)))[0]), pos)
    assert np.array_equal(stored_at(inplace_store(np.arange(m).reshape(SUB_POINTS, R).T), k), k)
    if R == 4:
        assert set(mk[k % R == 1] % R) == {3} and set(mk[k % R == 3] % R) == {1}


@pytest.mark.parametrize("n_fft", WIDE_N_FFT)
def test_model_of_wide_k1_matches_the_plain_version(n_fft):
    """K1 above n_fft 131072 in float64: K6's loader on the whole frame, the
    cross pass, the sub-rows' FFTs, the unpack from the sub-rows, against
    ``wave_stft_power_plain``: the frames over both reflection edges and an
    interior one of a signal of 2.5 frames (interior frames take the same
    path with direct loads)."""
    m, hop = n_fft // 2, n_fft // 2
    window = stft_ops.padded_window(n_fft - n_fft // 8, n_fft).astype(np.float64)
    y = np.random.default_rng(n_fft).standard_normal(5 * n_fft // 4 + 3)
    cross, unpack = cross_tables64(m), table64(m)
    rows = np.array([packed_power(inplace_store(np.stack([np.fft.fft(s) for s in global_cross_pass(
        k6_frame_points(y, window, f * hop - m, m), cross)])), unpack)
        for f in range(1 + len(y) // hop)])
    want = kernels.wave_stft_power_plain(torch.from_numpy(y[None]), torch.from_numpy(window),
                                         hop, n_fft).numpy()[0]
    assert rows.shape == want.shape
    assert (np.abs(rows - want) <= 1e-9 * want.max(axis=-1, keepdims=True)).all()
