// Hand-written Hopper (sm_90a) kernels of the log-mel featurizer.
//
// Built by sed_tpu_torch/ops/cuda_featurizer.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsed_featurizer.so featurizer.cu
// into a shared library with a plain C interface, loaded with ctypes.  Every
// entry point launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() after the launch; the Python wrapper raises on non-zero.
// No fast-math: K2's accurate log10f (not __log10f) is part of the parity
// budget (log-mel <= 1e-4 dB against a float64 oracle).
//
// K1  sed_wave_stft_power
//   Replaces sed_tpu/ops/pallas_featurizer.py _make_wave_fft_power_kernel_roll
//   (driven by stft_power_from_waveform_pallas, impl='roll').
//   Computes, per centred frame of each signal, the reflect-padded frame times
//   the padded Hann window, its n_fft-point real DFT, and |X|^2 for the one-
//   sided bins 0..n_fft/2, in natural bin order.
//   Bound on an H100 SXM: bytes.  At 16 x 60 s it reads the 184 MB f32
//   waveform and writes 191 MB of power (~0.11 ms at 3.35 TB/s) against
//   ~4.5 GFLOP (~0.07 ms at 67 TFLOP/s FP32).  This simple design runs at
//   ~16x that bound, most likely limited by its 14 barrier-separated
//   shared-memory passes rather than device memory (PERF.md).
//   Design: one CTA per frame.  The frame is read straight from the raw
//   waveform (reflection computed on the index: no padded copy, no pre-pass)
//   and only where the window is non-zero.  It is packed as
//   z[j] = x[2j] + i*x[2j+1] into an n_fft/2-point complex buffer in dynamic
//   shared memory (128 KB at n_fft = 32768), stored bit-reversed, so an
//   in-place radix-2 DIT FFT in FP32 runs entirely on chip; the hermitian
//   unpack X[k] = E[k] + W_N^k O[k] then writes each power bin exactly once.
//   Twiddles W_N^k are float64 on the host, rounded once to f32.
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
//   against ~0.25 GFLOP.  At one CTA per row the 160 rows take two waves
//   of K1's ~80 us per-frame time, so it runs far above that bound.
//   Design: K1's without the framing: one CTA per row, the row read only
//   where the window is non-zero, and the same FFT core (fft_power_row:
//   packed_fft then unpacked_power, templated on the sample loader, so K1's
//   arithmetic is unchanged).
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
//   Design: K1's CTA per frame and FFT core (packed_fft), then the unpack
//   into a second shared buffer of m + 1 floats (the unpack reads z[k] and
//   z[m-k], so writing power over z in place would race), then K2's band
//   epilogue (mel_log_row) over that buffer.  z and the power take 192 KB of
//   dynamic shared memory at n_fft = 32768, set with cudaFuncSetAttribute.
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
//   Bound on an H100 SXM: bytes.  At 16 x 60 s it reads 184 MB and writes
//   382 MB (~0.169 ms at 3.35 TB/s) against ~4.3 GFLOP.
//   Design: K1's load, pack and FFT (packed_fft), stopping before the
//   unpack; each thread copies its bins of z out, real and imaginary parts
//   to their own arrays.
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

namespace {

constexpr int kStftThreads = 1024;
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

// The FFT core shared by K1, K3, K5 and K6: window the n_fft samples that
// load(a) returns (a = 0..n_fft-1; called only where the window is
// non-zero), pack even/odd samples as one complex point stored bit-reversed
// in z (n_fft/2 points of dynamic shared memory), and run an in-place
// radix-2 DIT FFT.  On return z holds Z = FFT_m(x_even + i*x_odd) in natural
// order, visible to the whole block.
template <typename Load>
__device__ __forceinline__ void packed_fft(const Load& load,
                                           const float* __restrict__ window,
                                           const float2* __restrict__ twiddle,
                                           float2* z, int log2_m) {
  const int m = 1 << log2_m;  // n_fft / 2 complex points

  // Window, pack even/odd samples as one complex point, store bit-reversed.
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const int a = 2 * j;
    const float w0 = window[a];
    const float w1 = window[a + 1];
    float re = 0.f, im = 0.f;
    if (w0 != 0.f) re = w0 * load(a);
    if (w1 != 0.f) im = w1 * load(a + 1);
    z[__brev(static_cast<unsigned>(j)) >> (32 - log2_m)] = make_float2(re, im);
  }
  __syncthreads();

  // In-place radix-2 decimation-in-time over m points.  At stage s a
  // butterfly joins points i and i + half with W_len^pos = W_N^(pos * N/len).
  for (int s = 1; s <= log2_m; ++s) {
    const int half = 1 << (s - 1);
    const int tw_shift = log2_m + 1 - s;
    for (int b = threadIdx.x; b < (m >> 1); b += blockDim.x) {
      const int pos = b & (half - 1);
      const int i = ((b >> (s - 1)) << s) + pos;
      const int k = i + half;
      const float2 w = twiddle[pos << tw_shift];
      const float2 u = z[i];
      const float2 v = z[k];
      const float tr = w.x * v.x - w.y * v.y;
      const float ti = w.x * v.y + w.y * v.x;
      z[i] = make_float2(u.x + tr, u.y + ti);
      z[k] = make_float2(u.x - tr, u.y - ti);
    }
    __syncthreads();
  }
}

// Power of one-sided bin k (0..m) from the packed spectrum z, by the
// hermitian unpack of the real-input spectrum:
//   E[k] = (Z[k] + conj(Z[m-k]))/2,  O[k] = (Z[k] - conj(Z[m-k]))/(2i),
//   X[k] = E[k] + W_N^k O[k] (k < m),  X[m] = E[0] - O[0].
// It reads z[k] and z[m-k] and writes nothing, so z must not be overwritten
// while any thread of the block still unpacks.
__device__ __forceinline__ float unpacked_power(const float2* z,
                                                const float2* __restrict__ twiddle,
                                                int k, int m) {
  if (k == m) {
    const float2 z0 = z[0];
    const float x = z0.x - z0.y;
    return x * x;
  }
  const float2 zk = z[k];
  const float2 zr = z[(m - k) & (m - 1)];
  const float er = 0.5f * (zk.x + zr.x);
  const float ei = 0.5f * (zk.y - zr.y);
  const float orr = 0.5f * (zk.y + zr.y);
  const float oi = -0.5f * (zk.x - zr.x);
  const float2 w = twiddle[k];
  const float xr = er + w.x * orr - w.y * oi;
  const float xi = ei + w.x * oi + w.y * orr;
  return xr * xr + xi * xi;
}

// K1's and K3's body: the packed FFT, then the one-sided power written to
// row (bins 0..m).
template <typename Load>
__device__ __forceinline__ void fft_power_row(const Load& load,
                                              const float* __restrict__ window,
                                              const float2* __restrict__ twiddle,
                                              float2* z, float* __restrict__ row,
                                              int log2_m) {
  packed_fft(load, window, twiddle, z, log2_m);
  const int m = 1 << log2_m;
  for (int k = threadIdx.x; k <= m; k += blockDim.x)
    row[k] = unpacked_power(z, twiddle, k, m);
}

// K2's and K5's epilogue over one row of one-sided power p (device or shared
// memory): out[b] = 10*log10(max(1e-10, sum_k p[k] * w_b[k])) for every band
// b, one warp per band at a time, each lane summing every 32nd bin of the
// band's own range with fmaf, then a shuffle tree.  The order of the sums
// depends only on the band, so K5's bands equal K2's bit for bit.
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
    if (lane == 0) out[b] = 10.f * log10f(fmaxf(acc, 1e-10f));
  }
}

// K1's loader: sample a of the centred frame starting at `start`, reflected
// on the index at both ends of the signal.
struct ReflectLoad {
  const float* y;
  long long start;
  long long n;
  __device__ __forceinline__ float operator()(int a) const {
    return y[reflect_index(start + a, n)];
  }
};

// K3's loader: sample a of a pre-framed row (float, or int16 PCM whose
// 1/32768 scale the caller folded into the window).
template <typename T>
struct RowLoad {
  const T* x;
  __device__ __forceinline__ float operator()(int a) const {
    return static_cast<float>(x[a]);
  }
};

__global__ void __launch_bounds__(kStftThreads)
wave_stft_power_kernel(const float* __restrict__ wave,
                       const float* __restrict__ window,
                       const float2* __restrict__ twiddle,  // W_N^k, k < n_fft/2
                       float* __restrict__ out,
                       long long n_samples, int n_frames, int hop, int log2_m) {
  extern __shared__ float2 z[];
  const int m = 1 << log2_m;  // n_fft / 2 complex points
  const long long frame = blockIdx.x;  // signal * n_frames + t
  const long long sig = frame / n_frames;
  const long long t = frame - sig * n_frames;
  // Centred: frame t starts at t*hop - n_fft/2.
  const ReflectLoad load{wave + sig * n_samples, t * hop - m, n_samples};
  fft_power_row(load, window, twiddle, z, out + frame * static_cast<long long>(m + 1),
                log2_m);
}

template <typename T>
__global__ void __launch_bounds__(kStftThreads)
frames_stft_power_kernel(const T* __restrict__ frames,
                         const float* __restrict__ window,
                         const float2* __restrict__ twiddle,  // W_N^k, k < n_fft/2
                         float* __restrict__ out, int log2_m) {
  extern __shared__ float2 z[];
  const int m = 1 << log2_m;
  const long long r = blockIdx.x;
  const RowLoad<T> load{frames + r * (2LL * m)};
  fft_power_row(load, window, twiddle, z, out + r * static_cast<long long>(m + 1),
                log2_m);
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

__global__ void __launch_bounds__(kStftThreads)
wave_stft_mel_log_kernel(const float* __restrict__ wave,
                         const float* __restrict__ window,
                         const float2* __restrict__ twiddle,  // W_N^k, k < n_fft/2
                         const int* __restrict__ band_lo,
                         const int* __restrict__ band_hi,
                         const int* __restrict__ band_off,
                         const float* __restrict__ weights,
                         float* __restrict__ out,
                         long long n_samples, int n_frames, int hop, int log2_m,
                         int n_mels) {
  extern __shared__ float2 z[];
  const int m = 1 << log2_m;
  float* power = reinterpret_cast<float*>(z + m);  // m + 1 bins after z
  const long long frame = blockIdx.x;
  const long long sig = frame / n_frames;
  const long long t = frame - sig * n_frames;
  const ReflectLoad load{wave + sig * n_samples, t * hop - m, n_samples};
  packed_fft(load, window, twiddle, z, log2_m);
  // The unpack reads z[k] and z[m-k]: it writes a separate buffer, never z.
  for (int k = threadIdx.x; k <= m; k += blockDim.x)
    power[k] = unpacked_power(z, twiddle, k, m);
  __syncthreads();
  mel_log_row(power, band_lo, band_hi, band_off, weights, out + frame * n_mels,
              n_mels);
}

__global__ void __launch_bounds__(kStftThreads)
wave_packed_fft_kernel(const float* __restrict__ wave,
                       const float* __restrict__ window,
                       const float2* __restrict__ twiddle,  // W_N^k, k < n_fft/2
                       float* __restrict__ out_re,
                       float* __restrict__ out_im,
                       long long n_samples, int n_frames, int hop, int log2_m) {
  extern __shared__ float2 z[];
  const int m = 1 << log2_m;
  const long long frame = blockIdx.x;
  const long long sig = frame / n_frames;
  const long long t = frame - sig * n_frames;
  const ReflectLoad load{wave + sig * n_samples, t * hop - m, n_samples};
  packed_fft(load, window, twiddle, z, log2_m);
  float* re = out_re + frame * m;
  float* im = out_im + frame * m;
  for (int k = threadIdx.x; k < m; k += blockDim.x) {
    const float2 v = z[k];
    re[k] = v.x;
    im[k] = v.y;
  }
}

template <typename T>
int launch_frames_stft_power(const void* frames, const void* window,
                             const void* twiddle, void* out, long long rows,
                             int log2_m, void* stream) {
  const int smem = static_cast<int>(sizeof(float2)) << log2_m;
  cudaError_t err = cudaFuncSetAttribute(
      frames_stft_power_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  frames_stft_power_kernel<T><<<static_cast<unsigned>(rows), kStftThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(frames), static_cast<const float*>(window),
      static_cast<const float2*>(twiddle), static_cast<float*>(out), log2_m);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sed_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int sed_wave_stft_power(const void* wave, const void* window,
                        const void* twiddle, void* out, long long n_signals,
                        long long n_samples, int n_frames, int hop, int log2_m,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int smem = static_cast<int>(sizeof(float2)) << log2_m;
  err = cudaFuncSetAttribute(wave_stft_power_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = n_signals * n_frames;
  wave_stft_power_kernel<<<static_cast<unsigned>(blocks), kStftThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wave), static_cast<const float*>(window),
      static_cast<const float2*>(twiddle), static_cast<float*>(out), n_samples,
      n_frames, hop, log2_m);
  return cudaGetLastError();
}

int sed_frames_stft_power(const void* frames, int frames_are_int16,
                          const void* window, const void* twiddle, void* out,
                          long long rows, int log2_m, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (frames_are_int16)
    return launch_frames_stft_power<short>(frames, window, twiddle, out, rows,
                                           log2_m, stream);
  return launch_frames_stft_power<float>(frames, window, twiddle, out, rows,
                                         log2_m, stream);
}

int sed_mel_log(const void* power, const void* band_lo, const void* band_hi,
                const void* band_off, const void* weights, void* out,
                long long rows, int n_bins, int n_mels, int device,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  mel_log_kernel<<<static_cast<unsigned>(rows), kMelThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(power), static_cast<const int*>(band_lo),
      static_cast<const int*>(band_hi), static_cast<const int*>(band_off),
      static_cast<const float*>(weights), static_cast<float*>(out), n_bins,
      n_mels);
  return cudaGetLastError();
}

int sed_wave_stft_mel_log(const void* wave, const void* window,
                          const void* twiddle, const void* band_lo,
                          const void* band_hi, const void* band_off,
                          const void* weights, void* out, long long n_signals,
                          long long n_samples, int n_frames, int hop, int log2_m,
                          int n_mels, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  // z (m float2) then the one-sided power (m + 1 floats).
  const int smem = static_cast<int>(sizeof(float2) << log2_m) +
                   static_cast<int>(sizeof(float)) * ((1 << log2_m) + 1);
  err = cudaFuncSetAttribute(wave_stft_mel_log_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = n_signals * n_frames;
  wave_stft_mel_log_kernel<<<static_cast<unsigned>(blocks), kStftThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wave), static_cast<const float*>(window),
      static_cast<const float2*>(twiddle), static_cast<const int*>(band_lo),
      static_cast<const int*>(band_hi), static_cast<const int*>(band_off),
      static_cast<const float*>(weights), static_cast<float*>(out), n_samples,
      n_frames, hop, log2_m, n_mels);
  return cudaGetLastError();
}

int sed_wave_packed_fft(const void* wave, const void* window,
                        const void* twiddle, void* out_re, void* out_im,
                        long long n_signals, long long n_samples, int n_frames,
                        int hop, int log2_m, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int smem = static_cast<int>(sizeof(float2)) << log2_m;
  err = cudaFuncSetAttribute(wave_packed_fft_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = n_signals * n_frames;
  wave_packed_fft_kernel<<<static_cast<unsigned>(blocks), kStftThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wave), static_cast<const float*>(window),
      static_cast<const float2*>(twiddle), static_cast<float*>(out_re),
      static_cast<float*>(out_im), n_samples, n_frames, hop, log2_m);
  return cudaGetLastError();
}

}  // extern "C"
