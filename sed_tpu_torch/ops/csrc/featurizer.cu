// Hand-written Hopper (sm_90a) kernels of the log-mel featurizer.
//
// Built by sed_tpu_torch/ops/cuda_featurizer.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsed_featurizer.so featurizer.cu
// into a shared library with a plain C interface, loaded with ctypes.  Every
// entry point launches on the caller's stream, allocates nothing, returns
// cudaGetLastError() after the launch (the Python wrapper raises on non-zero)
// and leaves the calling thread's current device as it found it (DeviceGuard).
// No fast-math: K2's accurate log10f (not __log10f) is part of the parity
// budget (log-mel <= 1e-4 dB against a float64 oracle).
//
// K1  sed_wave_stft_power
//   Replaces sed_tpu/ops/pallas_featurizer.py _make_wave_fft_power_kernel_roll
//   (driven by stft_power_from_waveform_pallas, impl='roll').
//   Computes, per centred frame of each signal, the reflect-padded frame times
//   the padded Hann window, its n_fft-point real DFT, and |X|^2 for the one-
//   sided bins 0..n_fft/2, in natural bin order.
//   Bound on an H100 SXM: bytes.  At 16 x 60 s (2912 frames, m = n_fft/2 =
//   16384) it reads the 184 MB f32 waveform and writes 191 MB of power
//   (~0.11 ms at 3.35 TB/s) against ~4.3 GFLOP (~0.065 ms at 67 TFLOP/s
//   FP32).
//   Design: K6's loader and FFT core with K3's power drain.  One CTA of m/16
//   threads per frame, a template on log2 m (1..14).  PackedWaveLoad reads
//   the frame straight from the raw waveform into registers, only where the
//   window is non-zero (the frames that reach an edge reflect on the index
//   through shared memory: no padded copy, no pre-pass); stockham_fft runs
//   the m-point FFT of z[j] = x[2j] + i*x[2j+1] in registers (three
//   exchanges at m = 16384); PowerStore unpacks X[k] = E[k] + W_N^k O[k]
//   (one more exchange brings the mirror bin Z[m-k]) and stores each power
//   bin once, straight to the row.  Both twiddle tables (the pass-ordered
//   inter-pass table and W_N^k) are float64 on the host, rounded once to f32.
//   Known divergence from sed_tpu: FP32 FFT butterflies in place of the TPU's
//   Precision.HIGHEST (bf16x6) matmul DFT stages, one-sided natural-order
//   power in place of all n_fft bins in the TPU's (k2, k1) tile layout.  The
//   1e-5 x frame-peak tests against the JAX kernel pin the result.
//
// K3  sed_frames_stft_power
//   Replaces sed_tpu/ops/pallas_featurizer.py _make_fft_power_kernel
//   (driven by stft_power_pallas, composed with K2 as logmel_frames_pallas):
//   the streaming tick's featurizer.
//   Computes, per pre-framed row of n_fft samples (float32, or int16 PCM with
//   the window pre-scaled by 1/32768 on the host, as stft_power_pallas does),
//   the windowed n_fft-point real DFT and |X|^2 for bins 0..n_fft/2, in
//   natural bin order (what K2 reads).
//   Bound on an H100 SXM: bytes.  At a 32-slot, 1 s tick it reads 160 rows of
//   f32 frames (21.0 MB) and writes 10.5 MB of power (~9.4 us at 3.35 TB/s)
//   against ~0.25 GFLOP.  At one CTA per row the 160 rows on 132 SMs take
//   two waves of one row's time, so it cannot come near that bound; splitting
//   a row over a thread-block cluster is the next step (ROADMAP queue 2).
//   Design: K6's core without the framing.  One CTA of m/16 threads per row,
//   a template on log2 m (1..14) and on the sample pair type.  PackedRowLoad
//   reads packed point t + s*m/16 as one float2 (short2 for int16) straight
//   into registers, only where the window is non-zero; stockham_fft runs the
//   m-point FFT in registers (three exchanges at m = 16384); PowerStore, the
//   drain, unpacks the packed spectrum to one-sided power: bin k needs Z[k]
//   and Z[m-k], which another thread holds, so Z goes once more through
//   shared memory (a fourth exchange, natural order, free of bank conflicts),
//   and X[k] = E[k] + W_N^k O[k] (W_N^k from K1's table, read contiguously)
//   is squared and stored straight to the row.
//   Known divergence from sed_tpu: FP32 FFT butterflies in place of the TPU's
//   HIGHEST-precision matmul DFT stages, one-sided natural-order power in
//   place of all n_fft bins in the (k2, k1) tile layout.
//
// K2  sed_mel_log
//   Replaces sed_tpu/ops/pallas_featurizer.py _make_mel_kernel_resident_fb
//   (driven by _mel_from_power_fb via _folded_mel_from_power).
//   Computes out[r, b] = 10*log10(max(1e-10, sum_k power[r, k] * fb[k, b])).
//   Bound on an H100 SXM: bytes.  It reads the power array once (191 MB at
//   16 x 60 s, ~0.057 ms at 3.35 TB/s); the arithmetic is ~0.2 GFLOP.
//   Design: the Slaney filterbank is 97% zeros and each band covers one
//   contiguous bin range, so each (row, band) is a warp-level reduction over
//   its own range only (about 33x less arithmetic than the dense product).
//   One CTA per row, one warp per band; overlapping neighbour bands re-read
//   the row through L1 rather than device memory.
//   Known divergence from sed_tpu: sparse FP32 band sums in place of the
//   TPU's dense bf16x4 split-operand matmul over the folded filterbank; the
//   1e-4 dB tests pin the result.
//   K2 also serves sed_tpu's _make_mel_kernel (K4: power_to_logmel_pallas,
//   and the filterbank streamed over K when it passes 24 MB): the same
//   function of one-sided power, for any number of bins, with no filterbank
//   size limit, so K4's counterpart is this kernel.
//
// K5  sed_wave_stft_mel_log
//   Replaces sed_tpu/ops/pallas_featurizer.py _make_wave_fft_mel_kernel_roll
//   (driven by logmel_waveform_fused, impl='fuse').
//   Computes K1 then K2 in one launch: per centred frame, the log-mel row,
//   with no power array in device memory.
//   Bound on an H100 SXM: operations.  At 16 x 60 s it reads the 184 MB
//   waveform and writes 0.75 MB (~0.055 ms at 3.35 TB/s) against ~4.5 GFLOP
//   of FFT and band sums (~0.068 ms at 67 TFLOP/s FP32).
//   Design: K1's kernel with PowerStore's row in shared memory: the m + 1
//   floats of power follow the 2m floats of the exchange buffer (the drain
//   still reads Z there), 12m + 4 bytes of dynamic shared memory (192 KB at
//   n_fft = 32768, set with cudaFuncSetAttribute); then a barrier and K2's
//   band epilogue (mel_log_row, one warp per band) over that buffer.  Below
//   n_fft = 1024 the CTA has fewer than 32 threads, so each thread takes
//   whole bands (mel_log_row_by_thread) and adds them in the warp's order.
//   One CTA of 192 KB per SM: the epilogue overlaps no other frame's FFT.
//   Same power code and summation order as K1 then K2, no fast-math: its
//   output equals K1 -> K2 bit for bit, as sed_tpu pins fuse == roll.
//
// K6  sed_wave_packed_fft
//   Replaces sed_tpu/ops/pallas_featurizer.py _make_wave_packed_fft_kernel
//   (driven by stft_packed_from_waveform_pallas, impl='pack').
//   Computes, per centred frame, Z = FFT_m((x_even + i*x_odd) * window) of
//   the m = n_fft/2 packed points, written as two (frames, m) f32 arrays
//   (real, imaginary) in natural bin order.  The hermitian unpack to one-
//   sided power follows in PyTorch (packed_power_onesided), as JAX runs it
//   in XLA, and K2 takes the mel.
//   Bound on an H100 SXM: bytes.  At 16 x 60 s (2912 frames, m = 16384) it
//   reads the 184 MB waveform and writes 382 MB of Z: 566 MB, ~0.169 ms at
//   3.35 TB/s, against ~3.4 GFLOP (~0.05 ms at 67 TFLOP/s FP32).
//   Design: stockham_fft, a radix-16 Stockham FFT held in registers, in
//   place of 14 barrier-separated radix-2 passes through shared memory
//   (1.77-1.80 ms on an H100 80GB HBM3 at 700 W, 10x the bound).
//   m = 16^a * r (r in 1, 2, 4, 8): a radix-16 passes, then one radix-r
//   pass; at m = 16384, 16*16*16*4, three exchanges through shared memory.
//   One CTA of m/16 threads per frame, 16 points a thread; the kernel is a
//   template on log2 m, so the schedule is unrolled and every address is a
//   base plus an immediate offset (64 registers at 1024 threads, no spills).
//   Interior frames load straight from the waveform into registers (thread
//   t reads packed points t + s*m/16, all 32 samples issued before any
//   arithmetic); the frames that reach an edge gather their reflected
//   samples through shared memory first.  The last pass stores bins
//   t + s*m/16 straight to out_re/out_im: natural order by the Stockham
//   indexing, no bit reversal.  The exchange buffer keeps re and im apart
//   (2 x 64 KB) under a bank swizzle that makes every exchange free of bank
//   conflicts.  The inter-pass twiddles are the f32-rounded float64 W_N^j
//   of K1's table, rearranged in pass order (stft.py stockham_twiddles) so
//   that each warp reads them contiguously.
//   Measured by chip_smoke.py phase 9 on an NVIDIA H100 80GB HBM3 at 700 W:
//   0.41 ms at 16 x 60 s (41% of the bound; torch.fft.fft of the packed
//   frames 0.31 ms).  Rebuilt without each part, it loses ~0.17 ms without
//   its loads (one frame in flight per SM: a frame's 128 KB of loads, its
//   passes and its stores do not overlap), ~0.11 ms without its exchanges
//   and ~0.07 ms without its twiddles (PERF.md section 6).
//   Known divergence from sed_tpu: natural bin order in place of the TPU's
//   (k2, k1) layout of the half transform (flat j = k2*n1 + k1 holds bin
//   n2*k1 + k2); the tests permute sed_tpu's output, never this one.
//
// K7 (impl 'eo'), K8 ('rollraw'), K9 ('rolledge') and K10 ('slice',
// 'roll_nodb') of sed_tpu compute K1's one-sided power (K9: K1 then K2) and
// differ only in how the TPU moves waveform bytes into VMEM; K1 already
// reads the raw waveform, reflects on the index and uses the even/odd
// identity X[k] = E[k] + W^k O[k], so their counterpart is K1.

#include <cuda_runtime.h>

#include <type_traits>
#include <utility>

namespace {

constexpr int kMelThreads = 256;

// Source index of padded position i (raw coordinates, may be < 0 or >= n)
// under np.pad(mode="reflect"): the edge sample is not repeated, and depths
// beyond the signal reflect again with period 2(n-1).
__device__ __forceinline__ long long reflect_index(long long i, long long n) {
  if (i >= 0 && i < n) return i;
  if (n == 1) return 0;
  const long long period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i < n ? i : period - i;
}

// |X[k]|^2 of one-sided bin k < m from zk = Z[k], zr = Z[(m-k) mod m] of the
// packed spectrum and w = W_N^k, by the hermitian unpack of the real-input
// spectrum:
//   E[k] = (Z[k] + conj(Z[m-k]))/2,  O[k] = (Z[k] - conj(Z[m-k]))/(2i),
//   X[k] = E[k] + W_N^k O[k] (k < m),  X[m] = E[0] - O[0].
__device__ __forceinline__ float hermitian_power(float2 zk, float2 zr, float2 w) {
  const float er = 0.5f * (zk.x + zr.x);
  const float ei = 0.5f * (zk.y - zr.y);
  const float orr = 0.5f * (zk.y + zr.y);
  const float oi = -0.5f * (zk.x - zr.x);
  const float xr = er + w.x * orr - w.y * oi;
  const float xi = ei + w.x * oi + w.y * orr;
  return xr * xr + xi * xi;
}

__device__ __forceinline__ float band_db(float sum) {
  return 10.f * log10f(fmaxf(sum, 1e-10f));
}

// K2's and K5's epilogue over one row of one-sided power p (device or shared
// memory): out[b] = 10*log10(max(1e-10, sum_k p[k] * w_b[k])) for every band
// b, one warp per band at a time, each lane summing every 32nd bin of the
// band's own range with fmaf, then a shuffle tree.  The order of the sums
// depends only on the band, so K5's bands equal K2's bit for bit.  Needs
// whole warps (blockDim.x a multiple of 32).
__device__ __forceinline__ void mel_log_row(const float* __restrict__ p,
                                            const int* __restrict__ band_lo,
                                            const int* __restrict__ band_hi,
                                            const int* __restrict__ band_off,
                                            const float* __restrict__ weights,
                                            float* __restrict__ out, int n_mels) {
  const int n_warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int b = warp; b < n_mels; b += n_warps) {
    const int lo = band_lo[b];
    const int hi = band_hi[b];
    const float* w = weights + band_off[b];
    float acc = 0.f;
#pragma unroll 4
    for (int k = lo + lane; k < hi; k += 32) acc = fmaf(p[k], w[k - lo], acc);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
    if (lane == 0) out[b] = band_db(acc);
  }
}

// mel_log_row for a block of fewer than 32 threads (K5 below n_fft = 1024):
// thread t takes bands t, t + T, ... whole and adds them in the warp's
// order, so they equal K2's bit for bit: the 32 lane sums (lane l: bins
// lo + l, lo + l + 32, ..., by fmaf), then the shuffle tree's additions
// (offset o = 16, 8, 4, 2, 1: sum[l] += sum[l + o] for l < o, all that lane
// 0 reads).  tests/test_torch_fft_plan.py models both orders.
__device__ __forceinline__ void mel_log_row_by_thread(const float* __restrict__ p,
                                                      const int* __restrict__ band_lo,
                                                      const int* __restrict__ band_hi,
                                                      const int* __restrict__ band_off,
                                                      const float* __restrict__ weights,
                                                      float* __restrict__ out, int n_mels) {
  for (int b = threadIdx.x; b < n_mels; b += blockDim.x) {
    const int lo = band_lo[b];
    const int hi = band_hi[b];
    const float* w = weights + band_off[b];
    float sum[32];
    for (int l = 0; l < 32; ++l) {
      float acc = 0.f;
      for (int k = lo + l; k < hi; k += 32) acc = fmaf(p[k], w[k - lo], acc);
      sum[l] = acc;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int l = 0; l < o; ++l) sum[l] += sum[l + o];
    out[b] = band_db(sum[0]);
  }
}

// ---------------------------------------------------------------------------
// stockham_fft: a radix-16 Stockham FFT of m = 2^k points (k = 1..14) held in
// registers.  Its index maths is modelled, under the same names, by
// tests/test_torch_fft_plan.py (radix_plan, slot_index, twiddle_index,
// exchange_index, swizzle), which holds it against np.fft.fft on the CPU.
// ---------------------------------------------------------------------------

constexpr int kPoints = 16;  // points a thread holds in registers

// Threads of a block over stockham_fft at m = 2^LOG2_M: m/16 (one below
// m = 16).  Each kernel's launch bound is its own thread count, so
// instances of fewer than 1024 threads may use more than 64 registers.
template <int LOG2_M>
constexpr int kStockhamThreads = LOG2_M < 4 ? 1 : (1 << LOG2_M) / kPoints;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// W_16^e for e = 1, 2, 3, 6, 9 (and W_8^1 = W_16^2, W_8^3 = W_16^6), from
// float64 rounded to f32; e = 4 is -i, applied exactly.
__device__ __forceinline__ float2 w16(int e) {
  constexpr float c1 = 0.923879532511286756f, s1 = 0.382683432365089772f;
  constexpr float h = 0.707106781186547524f;
  switch (e) {
    case 1: return make_float2(c1, -s1);
    case 2: return make_float2(h, -h);
    case 3: return make_float2(s1, -c1);
    case 6: return make_float2(-h, -h);
    default: return make_float2(-c1, s1);  // e = 9
  }
}

__device__ __forceinline__ float2 operator+(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 operator-(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 times_minus_i(float2 a) {
  return make_float2(a.y, -a.x);
}

// In-place radix-4 DFT of (a, b, c, d), outputs in natural order.
__device__ __forceinline__ void dft4(float2& a, float2& b, float2& c, float2& d) {
  const float2 s0 = a + c, d0 = a - c, s1 = b + d, d1 = times_minus_i(b - d);
  a = s0 + s1;
  b = d0 + d1;
  c = s0 - s1;
  d = d0 - d1;
}

// In-place radix-R DFT of u[0..R-1] (R = 2, 4, 8, 16), natural order out.
// R = 8: n = na + 2 nb, k = kb + 4 ka; R = 16: n = na + 4 nb, k = kb + 4 ka:
// radix-4 DFTs over nb, the internal twiddles W_R^(na*kb), then radix-2 or
// radix-4 DFTs over na.
template <int R>
__device__ __forceinline__ void dft(float2 (&u)[R]) {
  if constexpr (R == 2) {
    const float2 a = u[0];
    u[0] = a + u[1];
    u[1] = a - u[1];
  } else if constexpr (R == 4) {
    dft4(u[0], u[1], u[2], u[3]);
  } else if constexpr (R == 8) {
    dft4(u[0], u[2], u[4], u[6]);
    dft4(u[1], u[3], u[5], u[7]);
    u[3] = cmul(u[3], w16(2));
    u[5] = times_minus_i(u[5]);
    u[7] = cmul(u[7], w16(6));
    float2 x[8];
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      x[kb] = u[2 * kb] + u[2 * kb + 1];
      x[kb + 4] = u[2 * kb] - u[2 * kb + 1];
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) u[k] = x[k];
  } else {
    static_assert(R == 16, "radix 2, 4, 8 or 16");
#pragma unroll
    for (int na = 0; na < 4; ++na) dft4(u[na], u[na + 4], u[na + 8], u[na + 12]);
    // u[na + 4 kb] now holds Y[na][kb].
    u[5] = cmul(u[5], w16(1));
    u[6] = cmul(u[6], w16(2));
    u[7] = cmul(u[7], w16(3));
    u[9] = cmul(u[9], w16(2));
    u[10] = times_minus_i(u[10]);
    u[11] = cmul(u[11], w16(6));
    u[13] = cmul(u[13], w16(3));
    u[14] = cmul(u[14], w16(6));
    u[15] = cmul(u[15], w16(9));
#pragma unroll
    for (int kb = 0; kb < 4; ++kb)
      dft4(u[4 * kb], u[4 * kb + 1], u[4 * kb + 2], u[4 * kb + 3]);
    // u[4 kb + ka] now holds X[kb + 4 ka]: transpose to natural order.
    float2 x[16];
#pragma unroll
    for (int kb = 0; kb < 4; ++kb)
#pragma unroll
      for (int ka = 0; ka < 4; ++ka) x[kb + 4 * ka] = u[4 * kb + ka];
#pragma unroll
    for (int k = 0; k < 16; ++k) u[k] = x[k];
  }
}

// One Stockham pass of radix R after p points' worth of earlier radices.
// Thread t runs NB butterflies, i = t + b*T (T threads); butterfly i takes
// register slots b + NB*q (points i + q*m/R), scales slot q by
// W_{pR}^(q*k), k = i mod p, runs dft<R>, and leaves output q in the same
// slot.  The twiddles are in pass order (stft.py stockham_twiddles): entry
// q*p + k - 1 (twiddle_index), so neighbouring threads read neighbouring
// entries.
template <int R, int NB>
__device__ __forceinline__ void stockham_pass(float2 (&v)[R * NB],
                                              const float2* __restrict__ twiddle,
                                              int t, int T, int p) {
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    float2 u[R];
#pragma unroll
    for (int q = 0; q < R; ++q) u[q] = v[b + NB * q];
    if (p > 1) {
      const int k = (t + b * T) & (p - 1);
#pragma unroll
      for (int q = 1; q < R; ++q) u[q] = cmul(u[q], __ldg(twiddle + (q * p + k - 1)));
    }
    dft<R>(u);
#pragma unroll
    for (int q = 0; q < R; ++q) v[b + NB * q] = u[q];
  }
}

// Shared-memory position of exchange position a: a permutation inside each
// run of 32 floats that keeps every exchange below free of bank conflicts.
__device__ __forceinline__ int swizzle(int a) {
  return a ^ ((a >> 5) & 15) ^ (((a >> 8) & 1) << 4);
}

// After a pass of radix R (NB butterflies a thread) at stride p: output q
// of butterfly i goes to exchange_index (i/p)*p*R + (i mod p) + q*p; then
// every thread reads its slots back at slot_index t + T*s.  re and im have
// their own m floats.  A barrier first, so that no thread overwrites what
// another has not read yet; the first exchange needs none (a loader that
// uses shared memory ends with its own).
template <int R, int NB>
__device__ __forceinline__ void stockham_exchange(float2 (&v)[kPoints], float* sre,
                                                  float* sim, int t, int T, int p) {
  if (p > 1) __syncthreads();
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int i = t + b * T;
    const int k = i & (p - 1);
    const int base = (i - k) * R + k;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int a = swizzle(base + q * p);
      sre[a] = v[b + NB * q].x;
      sim[a] = v[b + NB * q].y;
    }
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kPoints; ++s) {
    const int a = swizzle(t + T * s);
    v[s] = make_float2(sre[a], sim[a]);
  }
}

// Z = FFT_m(z), m = 2^LOG2_M (1..14), of the packed, windowed points that
// load.fill() puts in registers, handed to store.drain() in natural order.
// Thread t of thread_count T = m/P threads holds P = min(16, m) points:
// slot s is point (and, at the end, bin) t + T*s.  m < 16 is one radix-m
// pass in one thread.  sre and sim are m floats each of shared memory.
// The schedule is a compile-time constant, so every address is a base plus
// an immediate offset.
template <int LOG2_M, typename Load, typename Store>
__device__ __forceinline__ void stockham_fft(const Load& load, const Store& store,
                                             const float2* __restrict__ twiddle,
                                             float* sre, float* sim) {
  constexpr int m = 1 << LOG2_M;
  constexpr int P = m < kPoints ? m : kPoints;
  constexpr int T = m / P;
  const int t = threadIdx.x;
  float2 v[kPoints];
  load.template fill<T, P>(v, t);
  if constexpr (LOG2_M < 4) {
    float2 u[m];
#pragma unroll
    for (int s = 0; s < m; ++s) u[s] = v[s];
    dft<m>(u);
#pragma unroll
    for (int s = 0; s < m; ++s) v[s] = u[s];
  } else {
    constexpr int a = LOG2_M >> 2;        // radix-16 passes
    constexpr int r = 1 << (LOG2_M & 3);  // the last pass's radix (1: none)
#pragma unroll
    for (int pass = 0, p = 1; pass < a; ++pass, p *= 16) {
      stockham_pass<16, 1>(v, twiddle, t, T, p);
      if (pass + 1 < a || r > 1) stockham_exchange<16, 1>(v, sre, sim, t, T, p);
    }
    constexpr int p = 1 << (4 * a);
    if constexpr (r == 2) stockham_pass<2, 8>(v, twiddle, t, T, p);
    if constexpr (r == 4) stockham_pass<4, 4>(v, twiddle, t, T, p);
    if constexpr (r == 8) stockham_pass<8, 2>(v, twiddle, t, T, p);
  }
  store.template drain<T, P>(v, t);
}

// K6's loader: packed point j = (x[2j], x[2j+1]) of the centred frame that
// starts at raw sample `start`, times the window, read only where the window
// is non-zero.  Interior frames (the whole frame inside the signal: all but
// the first and last one or two of each signal) load straight into
// registers, every load issued before any arithmetic.  The others gather the
// reflected samples into shared memory (sbuf, 2m floats: the exchange
// buffer, not yet in use) in a rolled loop, which keeps reflect_index's
// 64-bit arithmetic out of the interior path's registers.  Scalar loads: the
// signal's base is 8-byte aligned only for an even sig * n_samples.
struct PackedWaveLoad {
  const float* y;
  const float* window;
  long long start;
  long long n;
  bool interior;
  float* sbuf;
  template <int T, int P>
  __device__ __forceinline__ void fill(float2 (&v)[kPoints], int t) const {
    if (interior) {
      const float* x = y + start;
#pragma unroll
      for (int s = 0; s < P; ++s) {
        const int a = 2 * (t + T * s);
        const float w0 = window[a];
        const float w1 = window[a + 1];
        v[s] = make_float2(w0 != 0.f ? w0 * x[a] : 0.f, w1 != 0.f ? w1 * x[a + 1] : 0.f);
      }
      return;
    }
#pragma unroll 4
    for (int a = t; a < 2 * T * P; a += T) {
      const float w = window[a];
      sbuf[a] = w != 0.f ? w * y[reflect_index(start + a, n)] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < P; ++s) v[s] = reinterpret_cast<const float2*>(sbuf)[t + T * s];
    __syncthreads();  // sbuf is the exchange buffer
  }
};

// PackedWaveLoad of this block's frame, blockIdx.x = signal * n_frames + t,
// centred: it starts n_fft/2 = m samples before t * hop.  K1, K5 and K6.
template <int LOG2_M>
__device__ __forceinline__ PackedWaveLoad frame_load(const float* wave, const float* window,
                                                     long long n_samples, int n_frames,
                                                     int hop, float* sbuf) {
  constexpr int m = 1 << LOG2_M;
  const long long frame = blockIdx.x;
  const long long sig = frame / n_frames;
  const long long start = (frame - sig * n_frames) * hop - m;
  return {wave + sig * n_samples, window, start, n_samples,
          start >= 0 && start + 2LL * m <= n_samples, sbuf};
}

// K3's loader: packed point j = (x[2j], x[2j+1]) of a pre-framed row of
// Pair (float2: f32 samples; short2: int16 PCM, whose 1/32768 scale the
// caller folded into the window), times the window, read only where the
// window is non-zero.  A row starts at element r*2m and 2j is even, so each
// point is one aligned 8-byte (4-byte) load; a row is always interior, so
// every load goes straight into registers, all issued before any arithmetic.
template <typename Pair>
struct PackedRowLoad {
  const Pair* x;
  const float* window;
  template <int T, int P>
  __device__ __forceinline__ void fill(float2 (&v)[kPoints], int t) const {
#pragma unroll
    for (int s = 0; s < P; ++s) {
      const int j = t + T * s;
      const float w0 = window[2 * j];
      const float w1 = window[2 * j + 1];
      Pair p{};
      if (w0 != 0.f || w1 != 0.f) p = x[j];
      v[s] = make_float2(w0 != 0.f ? w0 * static_cast<float>(p.x) : 0.f,
                         w1 != 0.f ? w1 * static_cast<float>(p.y) : 0.f);
    }
  }
};

struct SplitStore {
  float* re;
  float* im;
  template <int T, int P>
  __device__ __forceinline__ void drain(const float2 (&v)[kPoints], int t) const {
#pragma unroll
    for (int s = 0; s < P; ++s) {
      re[t + T * s] = v[s].x;
      im[t + T * s] = v[s].y;
    }
  }
};

// The drain of K1, K3 (row in device memory) and K5 (row in shared memory,
// after the exchange buffer): |X[k]|^2 for k = 0..m to row from the
// packed spectrum in registers (slot s of thread t holds Z[k], k = t + T*s).
// Bin k needs Z[(m-k) mod m] too: for t > 0 thread T-t holds it in slot
// P-1-s, for t = 0 thread 0 in slot (P-s) mod P.  One thread (m <= 16) has
// them all; otherwise Z goes once more through the exchange buffer sre/sim
// (m floats each), after a barrier that lets the last exchange's reads
// finish.  That exchange keeps natural order, no swizzle: a warp writes 32
// neighbouring positions and reads their 32 mirrors, 32 neighbouring
// positions too, so both hit 32 banks.  W_N^k (K1's unpack table) is read at
// contiguous k; the stores are scalar and coalesced (a row of m + 1 floats
// is 4-byte aligned only).  Thread 0 also writes bin m, (Re Z0 - Im Z0)^2.
// tests/test_torch_fft_plan.py models it (drain_partner, drain_write_index,
// drain_read_index, power_drain).
struct PowerStore {
  float* row;
  const float2* twiddle;  // W_N^k, k < m
  float* sre;
  float* sim;
  template <int T, int P>
  __device__ __forceinline__ void drain(const float2 (&v)[kPoints], int t) const {
    constexpr int m = T * P;
    constexpr bool in_registers = T == 1;
    if (t == 0) {
      const float x = v[0].x - v[0].y;
      row[m] = x * x;
    }
    if constexpr (!in_registers) {
      __syncthreads();
#pragma unroll
      for (int s = 0; s < P; ++s) {
        sre[t + T * s] = v[s].x;
        sim[t + T * s] = v[s].y;
      }
      __syncthreads();
    }
#pragma unroll
    for (int s = 0; s < P; ++s) {
      const int k = t + T * s;
      float2 mirror;
      if constexpr (in_registers) {
        mirror = v[(P - s) % P];
      } else {
        const int a = (m - k) & (m - 1);
        mirror = make_float2(sre[a], sim[a]);
      }
      row[k] = hermitian_power(v[s], mirror, __ldg(twiddle + k));
    }
  }
};

template <int LOG2_M>
__global__ void __launch_bounds__(kStockhamThreads<LOG2_M>, 1)
wave_stft_power_kernel(const float* __restrict__ wave,
                       const float* __restrict__ window,
                       const float2* __restrict__ twiddle,  // stockham_twiddles
                       const float2* __restrict__ unpack,   // W_N^k, k < m
                       float* __restrict__ out,
                       long long n_samples, int n_frames, int hop) {
  extern __shared__ float exchange[];  // re: m floats, then im: m floats
  constexpr int m = 1 << LOG2_M;
  const auto load = frame_load<LOG2_M>(wave, window, n_samples, n_frames, hop, exchange);
  const PowerStore store{out + blockIdx.x * (m + 1LL), unpack, exchange, exchange + m};
  stockham_fft<LOG2_M>(load, store, twiddle, exchange, exchange + m);
}

// Rows of Pair: float2 (f32 samples) or short2 (int16 PCM).
template <int LOG2_M, typename Pair>
__global__ void __launch_bounds__(kStockhamThreads<LOG2_M>, 1)
frames_stft_power_kernel(const Pair* __restrict__ frames,
                         const float* __restrict__ window,
                         const float2* __restrict__ twiddle,  // stockham_twiddles
                         const float2* __restrict__ unpack,   // W_N^k, k < m
                         float* __restrict__ out) {
  extern __shared__ float exchange[];  // re: m floats, then im: m floats
  constexpr int m = 1 << LOG2_M;
  const long long r = blockIdx.x;
  const PackedRowLoad<Pair> load{frames + r * m, window};
  const PowerStore store{out + r * (m + 1LL), unpack, exchange, exchange + m};
  stockham_fft<LOG2_M>(load, store, twiddle, exchange, exchange + m);
}

__global__ void __launch_bounds__(kMelThreads)
mel_log_kernel(const float* __restrict__ power,
               const int* __restrict__ band_lo,
               const int* __restrict__ band_hi,
               const int* __restrict__ band_off,
               const float* __restrict__ weights,
               float* __restrict__ out,
               int n_bins, int n_mels) {
  const long long r = blockIdx.x;
  mel_log_row(power + r * n_bins, band_lo, band_hi, band_off, weights,
              out + r * n_mels, n_mels);
}

template <int LOG2_M>
__global__ void __launch_bounds__(kStockhamThreads<LOG2_M>, 1)
wave_stft_mel_log_kernel(const float* __restrict__ wave,
                         const float* __restrict__ window,
                         const float2* __restrict__ twiddle,  // stockham_twiddles
                         const float2* __restrict__ unpack,   // W_N^k, k < m
                         const int* __restrict__ band_lo,
                         const int* __restrict__ band_hi,
                         const int* __restrict__ band_off,
                         const float* __restrict__ weights,
                         float* __restrict__ out,
                         long long n_samples, int n_frames, int hop, int n_mels) {
  // re: m floats, im: m floats, then the power: m + 1 floats.
  extern __shared__ float exchange[];
  constexpr int m = 1 << LOG2_M;
  float* power = exchange + 2 * m;
  const auto load = frame_load<LOG2_M>(wave, window, n_samples, n_frames, hop, exchange);
  const PowerStore store{power, unpack, exchange, exchange + m};
  stockham_fft<LOG2_M>(load, store, twiddle, exchange, exchange + m);
  __syncthreads();
  float* row = out + blockIdx.x * static_cast<long long>(n_mels);
  if constexpr (kStockhamThreads<LOG2_M> < 32)
    mel_log_row_by_thread(power, band_lo, band_hi, band_off, weights, row, n_mels);
  else
    mel_log_row(power, band_lo, band_hi, band_off, weights, row, n_mels);
}

template <int LOG2_M>
__global__ void __launch_bounds__(kStockhamThreads<LOG2_M>, 1)
wave_packed_fft_kernel(const float* __restrict__ wave,
                       const float* __restrict__ window,
                       const float2* __restrict__ twiddle,  // stockham_twiddles
                       float* __restrict__ out_re,
                       float* __restrict__ out_im,
                       long long n_samples, int n_frames, int hop) {
  extern __shared__ float exchange[];  // re: m floats, then im: m floats
  constexpr int m = 1 << LOG2_M;
  const auto load = frame_load<LOG2_M>(wave, window, n_samples, n_frames, hop, exchange);
  const long long frame = blockIdx.x;
  const SplitStore store{out_re + frame * m, out_im + frame * m};
  stockham_fft<LOG2_M>(load, store, twiddle, exchange, exchange + m);
}

// A kernel over stockham_fft at m = 2^LOG2_M: kStockhamThreads threads a
// block; in dynamic shared memory the 2m floats of the exchange buffer, then
// extra_smem bytes of the kernel's own.
template <int LOG2_M, typename... Params, typename... Args>
int launch_stockham(void (*kernel)(Params...), long long blocks, int extra_smem,
                    cudaStream_t stream, const Args&... args) {
  constexpr int threads = kStockhamThreads<LOG2_M>;
  const int smem = static_cast<int>(sizeof(float2) << LOG2_M) + extra_smem;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// launch(std::integral_constant<int, log2_m>{}) for log2 m 1..14 (n_fft
// 4..32768), which instantiates `launch` once for each; cudaErrorInvalidValue
// for any other log2 m.
template <typename Launch, int... L>
int with_log2_m(int log2_m, const Launch& launch, std::integer_sequence<int, L...>) {
  int err = cudaErrorInvalidValue;
  (void)((log2_m == L + 1 ? (err = launch(std::integral_constant<int, L + 1>{}), true)
                          : false) || ...);
  return err;
}

template <typename Launch>
int with_log2_m(int log2_m, const Launch& launch) {
  return with_log2_m(log2_m, launch, std::make_integer_sequence<int, 14>{});
}

// Makes `device` the calling thread's current device for the guard's life and
// restores the caller's device on every return path, error paths included, so
// an entry point leaves the thread's device as it found it (later 'cuda'
// allocations of the caller stay where they were).  It switches only when the
// device differs.  Every extern "C" entry point that launches starts with one.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    status_ = cudaGetDevice(&caller_);
    if (status_ == cudaSuccess && caller_ != device) {
      status_ = cudaSetDevice(device);
      switched_ = status_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (switched_) cudaSetDevice(caller_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
  cudaError_t status() const { return status_; }

 private:
  int caller_ = 0;
  bool switched_ = false;
  cudaError_t status_;
};

}  // namespace

extern "C" {

const char* sed_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int sed_wave_stft_power(const void* wave, const void* window, const void* twiddle,
                        const void* unpack, void* out, long long n_signals,
                        long long n_samples, int n_frames, int hop, int log2_m,
                        int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return guard.status();
  const auto* w = static_cast<const float*>(wave);
  const auto* win = static_cast<const float*>(window);
  const auto* tw = static_cast<const float2*>(twiddle);
  const auto* unpack_tw = static_cast<const float2*>(unpack);
  auto* power = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  return with_log2_m(log2_m, [&](auto log2_m_constant) {
    constexpr int L = decltype(log2_m_constant)::value;
    return launch_stockham<L>(wave_stft_power_kernel<L>, n_signals * n_frames, 0, s, w, win,
                              tw, unpack_tw, power, n_samples, n_frames, hop);
  });
}

int sed_frames_stft_power(const void* frames, int frames_are_int16,
                          const void* window, const void* twiddle, const void* unpack,
                          void* out, long long rows, int log2_m, int device,
                          void* stream) {
  const DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return guard.status();
  const auto* w = static_cast<const float*>(window);
  const auto* tw = static_cast<const float2*>(twiddle);
  const auto* unpack_tw = static_cast<const float2*>(unpack);
  auto* power = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  return with_log2_m(log2_m, [&](auto log2_m_constant) {
    constexpr int L = decltype(log2_m_constant)::value;
    return frames_are_int16
               ? launch_stockham<L>(frames_stft_power_kernel<L, short2>, rows, 0, s,
                                    static_cast<const short2*>(frames), w, tw, unpack_tw, power)
               : launch_stockham<L>(frames_stft_power_kernel<L, float2>, rows, 0, s,
                                    static_cast<const float2*>(frames), w, tw, unpack_tw, power);
  });
}

int sed_mel_log(const void* power, const void* band_lo, const void* band_hi,
                const void* band_off, const void* weights, void* out,
                long long rows, int n_bins, int n_mels, int device,
                void* stream) {
  const DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return guard.status();
  mel_log_kernel<<<static_cast<unsigned>(rows), kMelThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(power), static_cast<const int*>(band_lo),
      static_cast<const int*>(band_hi), static_cast<const int*>(band_off),
      static_cast<const float*>(weights), static_cast<float*>(out), n_bins,
      n_mels);
  return cudaGetLastError();
}

int sed_wave_stft_mel_log(const void* wave, const void* window, const void* twiddle,
                          const void* unpack, const void* band_lo, const void* band_hi,
                          const void* band_off, const void* weights, void* out,
                          long long n_signals, long long n_samples, int n_frames, int hop,
                          int log2_m, int n_mels, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return guard.status();
  const auto* w = static_cast<const float*>(wave);
  const auto* win = static_cast<const float*>(window);
  const auto* tw = static_cast<const float2*>(twiddle);
  const auto* unpack_tw = static_cast<const float2*>(unpack);
  const auto* lo = static_cast<const int*>(band_lo);
  const auto* hi = static_cast<const int*>(band_hi);
  const auto* off = static_cast<const int*>(band_off);
  const auto* fb = static_cast<const float*>(weights);
  auto* mel = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  return with_log2_m(log2_m, [&](auto log2_m_constant) {
    constexpr int L = decltype(log2_m_constant)::value;
    // The one-sided power, m + 1 floats, after the exchange buffer.
    constexpr int power_bytes = static_cast<int>(sizeof(float)) * ((1 << L) + 1);
    return launch_stockham<L>(wave_stft_mel_log_kernel<L>, n_signals * n_frames, power_bytes,
                              s, w, win, tw, unpack_tw, lo, hi, off, fb, mel, n_samples,
                              n_frames, hop, n_mels);
  });
}

int sed_wave_packed_fft(const void* wave, const void* window,
                        const void* twiddle, void* out_re, void* out_im,
                        long long n_signals, long long n_samples, int n_frames,
                        int hop, int log2_m, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return guard.status();
  const auto* w = static_cast<const float*>(wave);
  const auto* win = static_cast<const float*>(window);
  const auto* tw = static_cast<const float2*>(twiddle);
  auto* re = static_cast<float*>(out_re);
  auto* im = static_cast<float*>(out_im);
  const auto s = static_cast<cudaStream_t>(stream);
  return with_log2_m(log2_m, [&](auto log2_m_constant) {
    constexpr int L = decltype(log2_m_constant)::value;
    return launch_stockham<L>(wave_packed_fft_kernel<L>, n_signals * n_frames, 0, s, w, win,
                              tw, re, im, n_samples, n_frames, hop);
  });
}

}  // extern "C"
