// Hand-written Hopper (sm_90a) kernels of the log-mel featurizer.
//
// Built by sed_tpu_torch/ops/cuda_featurizer.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -Xcompiler -fPIC -c featurizer.cu, five times side by side (with
//        -DSED_FEATURIZER_NO_TIERS, -DSED_FEATURIZER_TIERS_ONLY,
//        -DSED_FEATURIZER_PACKED_TIERS_ONLY, -DSED_FEATURIZER_WIDE_PACKED_ONLY,
//        -DSED_FEATURIZER_GEMM_TIERS_ONLY),
//   then nvcc -shared -o libsed_featurizer.so of the five objects,
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
//   threads per frame, a template on log2 m (1..16; above 14 a cluster of 2
//   or 4 CTAs a frame: cluster_fft, ClusterPowerStore).  PackedWaveLoad reads
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
//   a template on log2 m (1..16: a cluster above 14) and on the sample pair
//   type.  PackedRowLoad
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
//   16 x 60 s, ~0.057 ms at 3.35 TB/s; 10.5 MB for the streaming tick's 160
//   rows, ~0.0032 ms); the arithmetic is ~0.2 GFLOP.
//   Design: mel_log_kernel<R>.  The Slaney filterbank is 97% zeros and each
//   band covers one contiguous bin range, so only the bins [span_lo,
//   span_hi) that some band covers are read, and each band is summed over
//   its own range in segments of kSegBins bins (the band order above
//   segment_sums).  Persistent CTAs, as many as the card holds at once, walk
//   groups of R rows; one warp copies, 16 sum.  A row's span comes in chunks by
//   TMA bulk copies (cp.async.bulk) into a ring of shared memory, each chunk
//   completing on an mbarrier; a row need not start on a 16-byte boundary (a
//   row of 16,385 floats starts 4r mod 16 bytes past one), so the bulk copies
//   run from the boundary at or before span_lo and the < 4 bins before the
//   span's first boundary and after its last come by 4-byte cp.async on the
//   same mbarrier: every bin of the span is read once, no byte outside it (the
//   last row of an allocation included), and the copier never waits for device
//   memory.  It keeps up to D - 2 chunks ahead of the slowest summing warp,
//   which releases a slot when it no longer needs it.  The summing warps take
//   the segments in the order of their last bin, round-robin (work[], staged
//   with band_first in shared memory once per CTA): at step k the segments that
//   end in chunk k, from chunks k - 1 and k; a warp loads a segment's 8 weights
//   once and its bins of all R rows, then the R fmaf chains and shuffle trees.
//   R = 4 (a ring of 4 chunks of 2048 bins of 4 rows, 128 KB, one CTA an SM:
//   the 126.7 KB of weights are read once per 4 rows) once every SM has a group
//   of four; R = 1 below (16 chunks of 1024 bins, a whole default row in
//   flight, two CTAs an SM: the tick's 160 rows in one wave).  Each chunk costs
//   the copier a fixed time (PERF.md, the geometry sweep of
//   ops/mel_log_sweep.py), so chunks are as large as the ring allows.  The
//   segment sums go to shared memory; after a barrier of the summing warps, one
//   thread per (row, band) adds its band's segments and writes the log-mel.
//   One CTA per row with one warp per band, loading straight from device
//   memory, reaches half the bound: whole bands leave warps' shares uneven (up
//   to 1.23x the mean), each bin is loaded once per band it falls in, and the
//   weights once per row.
//   Known divergence from sed_tpu: sparse FP32 band sums in place of the
//   TPU's dense bf16x4 split-operand matmul over the folded filterbank; the
//   1e-4 dB tests pin the result.
//   K2 also serves sed_tpu's _make_mel_kernel (K4: power_to_logmel_pallas,
//   and the filterbank streamed over K when it passes 24 MB): the same
//   function of one-sided power, for any number of bins (the ring holds
//   chunks, not rows), with no filterbank size limit, so K4's counterpart is
//   this kernel.
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
//   still reads Z there), then n_seg floats of segment sums, 12m + 4 +
//   4 n_seg bytes of dynamic shared memory (~193 KB at n_fft = 32768, set
//   with cudaFuncSetAttribute); then a barrier and K2's band order
//   (mel_log_row): warp w sums segments w, w + 32, ... (at most 5 of the
//   default 156 on 32 warps, where a warp of whole bands took up to 2,234
//   bins), each with its loads issued before its fmafs and the next
//   segment's weights in flight, then one thread per band adds its
//   segments.  Below n_fft = 1024 the CTA has fewer than
//   32 threads, so each thread takes whole bands and sums each segment in
//   the warp's order (segment_sum_by_thread).  One CTA of ~193 KB per SM:
//   the epilogue overlaps no other frame's FFT, so it gets the even order
//   and the early loads, not a ring.  Same power code and summation order as
//   K1 then K2, no fast-math: its output equals K1 -> K2 bit for bit, as
//   sed_tpu pins fuse == roll.  Above n_fft 32768 a frame is a cluster
//   (cluster_fft): each CTA keeps its strided bins' power, and K2's segments
//   are summed over distributed shared memory as K5t sums them
//   (cluster_mel_log), still equal to K1 then K2 bit for bit.
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
//   Design: stockham_fft, a radix-16 Stockham FFT held in registers (over a
//   thread-block cluster above m = 16384: cluster_fft), in
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
// K5b  sed_wave_stft_mel_log at mel_passes 1 or 3
//   Replaces _make_wave_fft_mel_kernel_roll (:550) at precision None and
//   mel_precision 'bf16x1' / 'bf16x3' (its mel_dot, :580).  K5 with K2's
//   product modes (mel_fma) in its epilogue, chosen at run time
//   (mel_log_row_mode): the epilogue is bound by its loads, and one instance
//   per log2 m keeps the build as it was.  Equals K1 then K2 at that mode
//   bit for bit.
//
// K1t / K3t  sed_tier_split, then sed_tier_dft_power
//   (tier_split_kernel<C1, false>, then tier_fused_kernel<P1, P2, N1>)
//   Replaces sed_tpu/ops/pallas_featurizer.py _make_wave_fft_power_kernel_roll
//   (:412; K1t, and K7-K10 at a tier) and _make_fft_power_kernel (:283; K3t)
//   at a reduced precision: their dot_inner / dot_outer from _stage_dots
//   (:272) over _make_dot (:191), 'bf16x1' (turbo), 'bf16x3' (fast),
//   'bf16x4', 'bf16x6', or an (inner, outer) pair of them.
//   Computes sed_tpu's two-stage matmul DFT of each windowed frame, n_fft =
//   n1 * n2 (n1 = 2^(log2 n_fft / 2)): Y = W2 @ X over n2 (X[a][b] =
//   x[a n1 + b]), the f32 twiddle T = Y * W_N^(k2 b), Z = T @ W1 over n1,
//   |Z|^2 to bin n2 k1 + k2, for the one-sided bins 0..n_fft/2 in natural
//   order (K1's and K3's output, which K2 reads).  Each product is split as
//   _make_dot splits it: every operand into bf16 chunks by round to nearest
//   even (P = 1: one chunk; 3 and 4: hi, lo; 6: three), the (chunk, chunk)
//   terms of the tier (tier_term) accumulated in f32 on the tensor cores.
//   The frames are K1's framing (frame_load's start and interior test,
//   reflect_index) or K3's rows (float32, or int16 with the window
//   pre-scaled by 1/32768), read by the split pass.
//   Bound on an H100 SXM: operations at fast, bytes or operations at
//   turbo.  At 16 x 60 s (2912 frames, n1 128, n2 256) it reads the 184 MB
//   waveform and writes 191 MB of power (0.112 ms at 3.35 TB/s) against,
//   a frame, P1 x 4 n2^2 n1 + P2 x 8 n2 n1 (n1/2 + 1) tensor FLOP: 147 GFLOP
//   at turbo (0.149 ms at 989 TFLOP/s dense bf16), 442 at fast (0.447 ms).
//   Even at its bound, fast does not beat K1 (~0.4 ms) here.
//   Design: mma.sync fed by ldmatrix, a block barrier a tile, copies issued
//   by every thread and each block re-splitting its frame left Hopper's
//   tensor cores idle in the kernel this one replaced.  Here the split pass
//   writes each frame's bf16 chunks once, then tier_fused_kernel, one
//   persistent wgmma kernel of three warpgroups a CTA, takes both stages of
//   each (frame, 64 k2 rows) unit from bulk-copied tiles of the tier GEMMs'
//   tables and X planes, T kept in shared memory in the image stage 2's
//   wgmma reads (see the note at tier_fused_kernel).  It takes n_fft
//   2048..32768 (n1 32..128) but where four stage-1 passes would re-read
//   the table (fused_route); there, at 65536 and 131072 (n1 256, where T
//   and a ring do not fit 227 KB together) and outside 2048..131072 the tier
//   GEMMs (tier_inner_kernel, tier_outer_kernel) follow the split pass
//   instead.  sed_tier_fused_plan says which, and each launch takes a frame
//   group (X planes within 2 GiB).
//   Known divergence from sed_tpu: one-sided natural-order power in place of
//   all n_fft bins in the (k2, k1) layout with a folded filterbank; the
//   tensor cores' f32 accumulation (its order, its alignment of the terms)
//   in place of the MXU's: ~1e-5 x frame peak from the exact sums of the
//   plain version (wave_dft_power_bf16_plain), which tests hold against
//   sed_tpu's kernels at the same tier.  K2's bf16x1 / bf16x3 product modes
//   (mel_log_kernel<R, kPasses>, mel_fma) serve sed_tpu's mel_precision.
//
// K5t  K1t's launches, then sed_mel_log
//   Replaces _make_wave_fft_mel_kernel_roll (:550, driven by
//   logmel_waveform_fused, impl='fuse') at a reduced precision: its
//   _fft_power_body (:1294) through _stage_dots, then its mel epilogue at
//   mel_precision (None, 'bf16x4': f32; 'bf16x1', 'bf16x3': K2's modes).
//   Computes K1t then K2: K1t's route (the split pass, then tier_fused_kernel
//   or the tier GEMMs) to a power array, then K2 at mel_precision's mode,
//   equal to K1t then K2 by construction.
//   Bound on an H100 SXM: K1t's (operations at fast).
//   Design: a kernel of its own (tier_fused_kernel with K2's band sums over
//   a thread-block cluster a frame) was slower than this chain at every
//   tier in the same call (PERF.md section 6), so the chain runs it.
//
// K6t  sed_tier_packed_fft (tier_packed_fft_kernel<N1, P1, P2>)
//   Replaces _make_wave_packed_fft_kernel (:882, driven by
//   stft_packed_from_waveform_pallas, impl='pack') at a reduced precision:
//   its dot_inner / dot_outer (:933) over m = n_fft/2 points.
//   Computes K6's function, Z = DFT_m((x_even + i x_odd) * window) of each
//   centred frame in natural bin order, by sed_tpu's matmul DFT with bf16-
//   split products (n1 = 2^(log2 m / 2): n1 = n2 = 128 at n_fft 32768;
//   n_fft 4096..131072, n1 32..256).
//   Bound on an H100 SXM: operations at fast.  A frame: P1 x 8 n2^2 n1 + P2 x
//   8 n2 n1^2 tensor FLOP (sed_tpu's count, :1052): 293 GFLOP at fast and
//   16 x 60 s, 0.296 ms at 989 TFLOP/s dense bf16 (98 GFLOP, 0.099 ms at
//   turbo, where the 566 MB, 0.169 ms at 3.35 TB/s, bound it).
//   Design (mma.sync fed by ldmatrix, a block barrier a tile and copies
//   issued by every thread leave Hopper's tensor cores idle; wgmma from
//   shared memory, bulk copies and warp specialisation do not):
//   * wgmma.mma_async m64nNk16 (bf16 in, f32 out), both operands in shared
//     memory by descriptor under the 128-byte swizzle (sw128, K-major tiles
//     of 64 columns).  Stage 1 is [Yr; Yi] = [[W2r, -W2i]; [W2i, W2r]] [Xr;
//     Xi] as one real product (A: W2's rows of the unit, Yr and Yi
//     interleaved by 8 so a thread holds both of one (k2, b); B: the
//     frame's X, n1p rows b a pass, K tiles of Re z at 32 a then Im z at
//     the same a); stage 2 is Z^T = W1^T T^T (A: W1's rows, (k1, Zr / Zi)
//     interleaved by 8; B: T^T, kb rows k2 over K = [Tr | Ti]), so the
//     drain's rows are kb contiguous bins n2 k1 + k0 ...
//   * The tables: tab1 and tab2 are made once on the host in the exact
//     shared-memory image of each 64-row tile (cuda_featurizer.
//     _packed_tables), so one cp.async.bulk on an mbarrier brings a tile's
//     chunks (kb / 32 of them a ring-1 slot); a producer thread keeps them
//     in flight in two rings (stage 1's, d1 slots with the X tiles beside;
//     stage 2's, two slots).  Their layout does not depend on the
//     instance's shape, so the host needs nothing of packed_shape.
//   * The frame split: the producers (one or two warpgroups, the others of
//     the CTA) load the frame's samples and window pairs a step ahead
//     (8-byte loads where the frame is aligned), window them and split them
//     into bf16 chunks (cvt.rn.bf16x2) straight into X's swizzled B layout,
//     once per unit.  A unit is (frame, kb k2 rows), so a frame is split
//     n2 / kb times (twice at n_fft 32768): what a CTA holds is kb k2 rows
//     of one frame, not a whole frame, whose X and T^T (C1 x 4m and C2 x 4m
//     bytes) do not fit 227 KB beside the rings at n1 >= 128.
//   * Persistent CTAs, as many as fit (one an SM), walk the units, so one
//     unit's twiddle, stage 2 and drain overlap the producers' loads,
//     splits and copies of the next unit's first steps.
//   * The drain: each 64-row M tile of Z^T goes through shared memory to
//     16-byte coalesced stores of Zr and Zi rows, while the next tile's
//     first products run.
//   Shared memory (packed_shape; T^T C2 x 4 n1 kb B, ring 1 d1 x C1 (n1p +
//   2 kb) 128 B, ring 2 2 x C2 x 8 KB, the drain 256 (kb + 4) B): kb 64 up to
//   n1 128 (32 at n1 256, or where 6-pass chunks need the room), n1p up to
//   128, d1 3 or 2; 103-230 KB at every (n1, C1, C2).  With two producing
//   warpgroups (384 threads) setmaxnreg gives the multiplying warpgroup 240
//   registers, the producers 120.  Its tables' layout and the whole data
//   flow are modelled in numpy by tests/test_torch_packed_tiers.py.
//
// The sizes (cuda_featurizer.launch_plan says what each kernel launches at an
// n_fft; n_fft above 2^20 raises): K1, K3, K5 and K6 take every power of two
// 4..2^20, in one launch up to 131072 (above 32768 a frame a cluster of 2 or
// 4 CTAs: cluster_fft) and above it through the global cross pass
// (fft_cross_pass_kernel, fft_subrows_kernel, packed_power_kernel; K5 there
// is K1's launches, then K2: a frame's power does not stay on chip).  K2
// takes any bin count.  K1t and K3t take 128..2^20 and K6t 256..2^20
// (sed_tpu's smallest at a tier: its tiles are 128 lanes): K1t and K3t by
// the split pass, then tier_fused_kernel at 2048..32768 or the tier GEMMs
// (tier_inner_kernel and tier_outer_kernel on wgmma) elsewhere; K6t by its
// instances at 4096..131072 and the split pass and the tier GEMMs
// elsewhere; K5t takes 2048..2^20 ('fuse' needs n_fft % 2048 == 0), its
// fused kernel where K1t's, K1t's GEMMs then K2 above.  One mechanism serves
// both ends of the tier kernels' range: the units' 64 k2 rows and wgmma's M
// of 64 do not fit n1 = 8..16 below, nor T beside a ring in 227 KB at n1
// 256..1024 above.
//
// K7 (impl 'eo'), K8 ('rollraw'), K9 ('rolledge') and K10 ('slice',
// 'roll_nodb') of sed_tpu compute K1's one-sided power (K9: K1 then K2) and
// differ only in how the TPU moves waveform bytes into VMEM; K1 already
// reads the raw waveform, reflects on the index and uses the even/odd
// identity X[k] = E[k] + W^k O[k], so their counterpart is K1.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <type_traits>
#include <utility>

// One object of the library that holds one tier kernel's entry point alone
// (see the tier entry points at the end).
#if defined(SED_FEATURIZER_TIERS_ONLY) || defined(SED_FEATURIZER_PACKED_TIERS_ONLY) || \
    defined(SED_FEATURIZER_WIDE_PACKED_ONLY) || defined(SED_FEATURIZER_GEMM_TIERS_ONLY)
#define SED_FEATURIZER_ONE_TIER_UNIT
#endif

namespace {

namespace cg = cooperative_groups;

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

// ---------------------------------------------------------------------------
// The band sums of K2 and K5, in one order that depends on the band alone.
// cuda_featurizer.mel_segments_numpy cuts band b's bin range [lo, hi) into
// segments of kSegBins bins counted from lo (the last one shorter) and lists
// them band-major as int4 (first bin, bins, weight offset, band); band b owns
// segments band_first[b] .. band_first[b + 1] - 1.  Then:
//   segment sum: lane l adds bins first + l + 32j (j = 0..7, inside the
//     segment) by fmaf, from 0, then the __shfl_down_sync tree (16, 8, 4, 2,
//     1) brings the sum to lane 0;
//   band sum: 0, plus the segment sums left to right; then band_db.
// A band no wider than kSegBins is one segment: one warp's sum over the whole
// band.  Warps take segments, not bands, so a warp's share is even.  K2 sums
// the segments of R rows at once from its ring of shared memory; K5 sums one
// row already in shared memory, with warps or, below 32 threads, one thread per
// band (segment_sum_by_thread).  The same functions in the same order: K5
// equals K1 then K2 bit for bit. tests/test_torch_fft_plan.py models them
// (lane_sums, warp_shuffle_sum, by_thread_sum, band_sum).
// ---------------------------------------------------------------------------

constexpr int kSegBins = 256;             // bins of a full segment
constexpr int kSegSteps = kSegBins / 32;  // bins a lane adds in a segment

// A segment is an int4 (first bin, bins, weight offset, band or index).

// The lane's weights of segment s: bins s.x + lane + 32j, j < kSegSteps.
// The weights array ends in kSegBins zeros, so a short segment's loads past
// its end stay inside it; segment_sums leaves those lanes' values out.
__device__ __forceinline__ void segment_weights(const float* __restrict__ weights, int4 s,
                                                int lane, float (&w)[kSegSteps]) {
#pragma unroll
  for (int j = 0; j < kSegSteps; ++j) w[j] = __ldg(weights + s.z + lane + 32 * j);
}

// f32 -> the f32 value of its bf16 rounding (round to nearest even, as
// astype(jnp.bfloat16) and torch's .to(torch.bfloat16) round).
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// acc + x * w at K2's product mode kPasses: 0, f32 (the parity mel, which
// serves sed_tpu's None and 'bf16x4'); 1, sed_tpu's 'bf16x1': x and w
// rounded to bf16, their product exact in f32; 3, 'bf16x3': the hi*hi +
// hi*lo + lo*hi terms of the bf16 splits (lo = bf16(v - hi)), each exact.
template <int kPasses>
__device__ __forceinline__ float mel_fma(float x, float w, float acc) {
  if constexpr (kPasses == 0) {
    return fmaf(x, w, acc);
  } else {
    const float xh = bf16_round(x), wh = bf16_round(w);
    if constexpr (kPasses == 1) return fmaf(xh, wh, acc);
    acc = fmaf(xh, wh, acc);
    acc = fmaf(xh, bf16_round(w - wh), acc);
    return fmaf(bf16_round(x - xh), wh, acc);
  }
}

// A segment's sums of R rows from the lane's power bins x[r][j] (bin
// first + lane + 32j of row r) and weights w[j], loaded before this call
// (past the segment's end, whatever lies there: only the lane's bins inside
// the segment enter its fmaf chain); lane 0 is left with them in sum[].
// kPasses: the product mode (mel_fma).
template <int R, int kPasses = 0>
__device__ __forceinline__ void segment_sums(const float (&x)[R][kSegSteps],
                                             const float (&w)[kSegSteps], int bins, int lane,
                                             float (&sum)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kSegSteps; ++j)
      if (lane + 32 * j < bins) acc = mel_fma<kPasses>(x[r][j], w[j], acc);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
    sum[r] = acc;
  }
}

// segment_sums' sum for one thread alone: the 32 lane sums, then the shuffle
// tree's additions in the order lane 0 sees them (offset o = 16, 8, 4, 2,
// 1: sum[l] += sum[l + o] for l < o).
template <int kPasses>
__device__ __forceinline__ float segment_sum_by_thread(const float* __restrict__ p,
                                                       const float* __restrict__ weights,
                                                       int4 s) {
  float sum[32];
  for (int l = 0; l < 32; ++l) {
    float acc = 0.f;
    for (int k = l; k < s.y; k += 32)
      acc = mel_fma<kPasses>(p[s.x + k], __ldg(weights + s.z + k), acc);
    sum[l] = acc;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int l = 0; l < o; ++l) sum[l] += sum[l + o];
  return sum[0];
}

// A band's sum: 0, plus its segments' sums seg_sums[first..end) left to
// right.
__device__ __forceinline__ float band_sum(const float* seg_sums, int first, int end) {
  float s = 0.f;
  for (int i = first; i < end; ++i) s += seg_sums[i];
  return s;
}

// K5's band epilogue over one row of one-sided power p in shared memory:
// out[b] = band_db of band b's sum for every band, at K2's product mode
// kPasses (mel_fma).  kWarps: warp w takes segments w, w + warps, ... into
// seg_sums (n_seg floats of shared memory), loading a segment's descriptor
// two segments ahead and its weights one ahead; then a barrier and one
// thread per band.  Otherwise (fewer than 32 threads) thread t takes bands
// t, t + T, ... whole.
template <bool kWarps, int kPasses>
__device__ __forceinline__ void mel_log_row(const float* p, const int4* __restrict__ seg,
                                            const int* __restrict__ band_first,
                                            const float* __restrict__ weights, float* seg_sums,
                                            float* __restrict__ out, int n_mels, int n_seg) {
  const auto descriptor = [seg, n_seg](int i) {
    return i < n_seg ? __ldg(seg + i) : make_int4(0, 0, 0, 0);
  };
  if constexpr (kWarps) {
    const int n_warps = blockDim.x >> 5;
    const int lane = threadIdx.x & 31;
    int i = threadIdx.x >> 5;
    int4 s = descriptor(i);
    int4 after = descriptor(i + n_warps);
    float w[kSegSteps];
    segment_weights(weights, s, lane, w);
    for (; i < n_seg; i += n_warps) {
      const int4 next = after;
      after = descriptor(i + 2 * n_warps);
      float next_w[kSegSteps];
      segment_weights(weights, next, lane, next_w);
      float x[1][kSegSteps];
#pragma unroll
      for (int j = 0; j < kSegSteps; ++j) x[0][j] = p[s.x + lane + 32 * j];
      float sum[1];
      segment_sums<1, kPasses>(x, w, s.y, lane, sum);
      if (lane == 0) seg_sums[i] = sum[0];
      s = next;
#pragma unroll
      for (int j = 0; j < kSegSteps; ++j) w[j] = next_w[j];
    }
    __syncthreads();
    for (int b = threadIdx.x; b < n_mels; b += blockDim.x)
      out[b] = band_db(band_sum(seg_sums, __ldg(band_first + b), __ldg(band_first + b + 1)));
  } else {
    for (int b = threadIdx.x; b < n_mels; b += blockDim.x) {
      float s = 0.f;
      const int end = __ldg(band_first + b + 1);
      for (int k = __ldg(band_first + b); k < end; ++k)
        s += segment_sum_by_thread<kPasses>(p, weights, descriptor(k));
      out[b] = band_db(s);
    }
  }
}

// mel_log_row at the product mode mel_passes (0, 1 or 3) chosen at run time:
// K5's epilogue is bound by its loads, not by the mode's extra roundings.
template <bool kWarps>
__device__ __forceinline__ void mel_log_row_mode(int mel_passes, const float* p,
                                                 const int4* __restrict__ seg,
                                                 const int* __restrict__ band_first,
                                                 const float* __restrict__ weights,
                                                 float* seg_sums, float* __restrict__ out,
                                                 int n_mels, int n_seg) {
  switch (mel_passes) {
    case 1: return mel_log_row<kWarps, 1>(p, seg, band_first, weights, seg_sums, out, n_mels,
                                          n_seg);
    case 3: return mel_log_row<kWarps, 3>(p, seg, band_first, weights, seg_sums, out, n_mels,
                                          n_seg);
    default: return mel_log_row<kWarps, 0>(p, seg, band_first, weights, seg_sums, out, n_mels,
                                           n_seg);
  }
}

// ---------------------------------------------------------------------------
// stockham_fft: a radix-16 Stockham FFT of m = 2^k points (k = 1..14) held in
// registers.  Its index maths is modelled, under the same names, by
// tests/test_torch_fft_plan.py (radix_plan, slot_index, twiddle_index,
// exchange_index, swizzle), which holds it against np.fft.fft on the CPU.
// ---------------------------------------------------------------------------

constexpr int kPoints = 16;  // points a thread holds in registers

// The most points one CTA's FFT holds: 2^14 (its exchange buffer, 128 KB).
// Above it (n_fft 65536, 131072) a frame's m points are spread over a
// thread-block cluster of kClusterCtas CTAs of 2^14 points each
// (cluster_fft below).
constexpr int kCtaLog2M = 14;
template <int LOG2_M>
constexpr int kClusterCtas = LOG2_M > kCtaLog2M ? 1 << (LOG2_M - kCtaLog2M) : 1;

// Threads of a block over stockham_fft at m = 2^LOG2_M: m/16 (one below
// m = 16; 1024 for a cluster's CTA).  Each kernel's launch bound is its own
// thread count, so instances of fewer than 1024 threads may use more than 64
// registers.
template <int LOG2_M>
constexpr int kStockhamThreads =
    LOG2_M < 4 ? 1 : (1 << (LOG2_M < kCtaLog2M ? LOG2_M : kCtaLog2M)) / kPoints;

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

// PackedWaveLoad of packed points first .. first + points - 1 of frame
// `frame` = signal * n_frames + t, centred: the frame starts n_fft/2 = m
// samples before t * hop.  K1, K5 and K6: the whole frame (first 0, points
// m, frame blockIdx.x), or a cluster CTA's chunk of it.
template <int LOG2_M>
__device__ __forceinline__ PackedWaveLoad frame_load(const float* wave, const float* window,
                                                     long long n_samples, int n_frames,
                                                     int hop, float* sbuf, long long frame,
                                                     int first = 0,
                                                     int points = 1 << LOG2_M) {
  constexpr int m = 1 << LOG2_M;
  const long long sig = frame / n_frames;
  const long long start = (frame - sig * n_frames) * hop - m + 2LL * first;
  return {wave + sig * n_samples, window + 2 * first, start, n_samples,
          start >= 0 && start + 2LL * points <= n_samples, sbuf};
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

// ---------------------------------------------------------------------------
// cluster_fft: the m = C * M point FFT (M = 2^14, C = 2 or 4: n_fft 65536,
// 131072) of one frame over a thread-block cluster of C CTAs, each with
// stockham_fft<14>'s 1024 threads and 128 KB exchange buffer.  One radix-C
// pass crosses the cluster, first (decimation in frequency): with n = n1 +
// M q and k = r + C k1 (n1, k1 < M; q, r < C),
//   Z[r + C k1] = sum_n1 W_M^(n1 k1) W_m^(n1 r) sum_q z[n1 + M q] W_C^(q r),
// so CTA r loads chunk r (points rM .. rM + M - 1: contiguous loads, each
// sample read by one CTA), reads the other chunks at the same n1 over
// distributed shared memory, keeps output r of the C-point DFT (exact:
// W_C^(q r) is 1, -i, -1 or i), twiddles it by W_m^(n1 r) (float64 on the
// host, rounded once to f32, after the sub-FFT's pass table) and runs its
// M-point FFT: it holds bins r + C k1, strided by C.  Decimation in time
// (the cross pass last) would give contiguous bins but strided loads and a
// framing whose reflected edges span every CTA; here the loader is K1's,
// K3's or K6's own on one chunk, and the mirror bin m - k of bin r + C k1 is
// bin (C - r) mod C + C k1' with k1' = M - 1 - k1 (r > 0) or (M - k1) mod M
// (r = 0): in the same CTA at C = 2, in CTA C - r for r = 1, 3 at C = 4.
// tests/test_torch_fft_plan.py models it (cross_pass, cluster_partner).
// ---------------------------------------------------------------------------

// x * W_C^e, W_C = exp(-2 pi i / C), C = 2 or 4: a power of -i, exact.
template <int C>
__device__ __forceinline__ float2 rotate(float2 x, int e) {
  switch ((e * (4 / C)) & 3) {
    case 0: return x;
    case 1: return times_minus_i(x);
    case 2: return make_float2(-x.x, -x.y);
    default: return make_float2(-x.y, x.x);
  }
}

// The cross pass, as stockham_fft's loader: CTA r fills its registers with
// its chunk by `chunk` (slot s of thread t: point n1 = t + T*s), puts them in
// its exchange buffer (natural order), and after a cluster barrier replaces
// each by sum_q (chunk q at n1) W_C^(q r), q in order, times W_m^(n1 r)
// (cross: row r of the (C, M) table).  A second cluster barrier lets every
// CTA finish its remote reads before any exchange overwrites a buffer.
template <int C, typename Load>
struct CrossLoad {
  Load chunk;
  const float2* cross;
  float* sre;
  float* sim;
  template <int T, int P>
  __device__ __forceinline__ void fill(float2 (&v)[kPoints], int t) const {
    constexpr int M = T * P;
    chunk.template fill<T, P>(v, t);
#pragma unroll
    for (int s = 0; s < P; ++s) {
      sre[t + T * s] = v[s].x;
      sim[t + T * s] = v[s].y;
    }
    cg::cluster_group cluster = cg::this_cluster();
    const int r = static_cast<int>(cluster.block_rank());
    cluster.sync();
    const float* re[C];
    const float* im[C];
#pragma unroll
    for (int q = 0; q < C; ++q) {
      re[q] = cluster.map_shared_rank(sre, q);
      im[q] = cluster.map_shared_rank(sim, q);
    }
#pragma unroll
    for (int s = 0; s < P; ++s) {
      const int n1 = t + T * s;
      float2 acc = r == 0 ? v[s] : make_float2(re[0][n1], im[0][n1]);
#pragma unroll
      for (int q = 1; q < C; ++q) {
        const float2 x = q == r ? v[s] : make_float2(re[q][n1], im[q][n1]);
        acc = acc + rotate<C>(x, q * r);
      }
      v[s] = r == 0 ? acc : cmul(acc, __ldg(cross + r * M + n1));
    }
    cluster.sync();
  }
};

// PowerStore over a cluster: |X[k]|^2 of the CTA's bins k = r + C k1 (slot
// s of thread t: k1 = t + T*s) to dst[k1 * stride], bin m (CTA 0) to
// *nyquist.  Z goes through the exchange buffer in natural k1 order (after a
// barrier that lets the last exchange's reads finish); after a cluster
// barrier each thread reads the mirror from CTA (C - r) mod C, at M - 1 - k1
// (r > 0) or (M - k1) mod M (r = 0); a last cluster barrier keeps every
// buffer alive until its partner has read it.  hermitian_power and W_N^k as
// PowerStore's.
template <int C>
struct ClusterPowerStore {
  float* dst;
  int stride;
  float* nyquist;
  const float2* twiddle;  // W_N^k, k < m
  float* sre;
  float* sim;
  template <int T, int P>
  __device__ __forceinline__ void drain(const float2 (&v)[kPoints], int t) const {
    constexpr int M = T * P;
    cg::cluster_group cluster = cg::this_cluster();
    const int r = static_cast<int>(cluster.block_rank());
    if (r == 0 && t == 0) {
      const float x = v[0].x - v[0].y;
      *nyquist = x * x;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < P; ++s) {
      sre[t + T * s] = v[s].x;
      sim[t + T * s] = v[s].y;
    }
    cluster.sync();
    const int partner = (C - r) & (C - 1);
    const float* pre = cluster.map_shared_rank(sre, partner);
    const float* pim = cluster.map_shared_rank(sim, partner);
#pragma unroll
    for (int s = 0; s < P; ++s) {
      const int k1 = t + T * s;
      const int a = r == 0 ? (M - k1) & (M - 1) : M - 1 - k1;
      dst[static_cast<long long>(k1) * stride] =
          hermitian_power(v[s], make_float2(pre[a], pim[a]), __ldg(twiddle + r + C * k1));
    }
    cluster.sync();
  }
};

// SplitStore over a cluster: Z[r + C k1] to re/im (the frame's rows).
template <int C>
struct ClusterSplitStore {
  float* re;
  float* im;
  template <int T, int P>
  __device__ __forceinline__ void drain(const float2 (&v)[kPoints], int t) const {
    const int r = static_cast<int>(cg::this_cluster().block_rank());
#pragma unroll
    for (int s = 0; s < P; ++s) {
      const long long k = r + C * static_cast<long long>(t + T * s);
      re[k] = v[s].x;
      im[k] = v[s].y;
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
  extern __shared__ float exchange[];  // re: m floats, then im: m floats (M: a cluster's CTA)
  constexpr int m = 1 << LOG2_M;
  constexpr int C = kClusterCtas<LOG2_M>;
  if constexpr (C == 1) {
    const auto load = frame_load<LOG2_M>(wave, window, n_samples, n_frames, hop, exchange,
                                          blockIdx.x);
    const PowerStore store{out + blockIdx.x * (m + 1LL), unpack, exchange, exchange + m};
    stockham_fft<LOG2_M>(load, store, twiddle, exchange, exchange + m);
  } else {
    constexpr int M = m / C;
    const long long frame = blockIdx.x / C;
    const int r = static_cast<int>(blockIdx.x % C);
    float* row = out + frame * (m + 1LL);
    const CrossLoad<C, PackedWaveLoad> load{
        frame_load<LOG2_M>(wave, window, n_samples, n_frames, hop, exchange, frame, r * M, M),
        twiddle + M, exchange, exchange + M};
    const ClusterPowerStore<C> store{row + r, C, row + m, unpack, exchange, exchange + M};
    stockham_fft<kCtaLog2M>(load, store, twiddle, exchange, exchange + M);
  }
}

// Rows of Pair: float2 (f32 samples) or short2 (int16 PCM).
template <int LOG2_M, typename Pair>
__global__ void __launch_bounds__(kStockhamThreads<LOG2_M>, 1)
frames_stft_power_kernel(const Pair* __restrict__ frames,
                         const float* __restrict__ window,
                         const float2* __restrict__ twiddle,  // stockham_twiddles
                         const float2* __restrict__ unpack,   // W_N^k, k < m
                         float* __restrict__ out) {
  extern __shared__ float exchange[];  // re: m floats, then im: m floats (M: a cluster's CTA)
  constexpr int m = 1 << LOG2_M;
  constexpr int C = kClusterCtas<LOG2_M>;
  if constexpr (C == 1) {
    const long long r = blockIdx.x;
    const PackedRowLoad<Pair> load{frames + r * m, window};
    const PowerStore store{out + r * (m + 1LL), unpack, exchange, exchange + m};
    stockham_fft<LOG2_M>(load, store, twiddle, exchange, exchange + m);
  } else {
    constexpr int M = m / C;
    const long long row = blockIdx.x / C;
    const int r = static_cast<int>(blockIdx.x % C);
    float* power = out + row * (m + 1LL);
    const CrossLoad<C, PackedRowLoad<Pair>> load{
        {frames + row * m + r * M, window + 2 * r * M}, twiddle + M, exchange, exchange + M};
    const ClusterPowerStore<C> store{power + r, C, power + m, unpack, exchange, exchange + M};
    stockham_fft<kCtaLog2M>(load, store, twiddle, exchange, exchange + M);
  }
}

// ---------------------------------------------------------------------------
// K2: mel_log_kernel<R>, persistent CTAs over groups of R rows, each row read
// from device memory once through a ring of shared memory.
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 bytes from device to shared memory by cp.async; async_copy_arrive makes
// bar count one arrival (of those it was set up to expect) once the calling
// thread's copies so far have landed.
__device__ __forceinline__ void async_copy_4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_address(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void async_copy_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_address(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_address(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_address(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_address(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_address(bar)), "r"(parity)
        : "memory");
  }
}

// One bulk copy (TMA, no tensor map) of `bytes` (a multiple of 16, both
// addresses 16-byte aligned) from device to shared memory, completing on bar.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_address(dst)), "l"(src), "r"(bytes), "r"(smem_address(bar))
      : "memory");
}

constexpr int kMelConsumerWarps = 16;  // warps that sum; one more warp copies
constexpr int kMelThreads = 32 * (kMelConsumerWarps + 1);
constexpr int kMelRows = 4;            // rows a CTA sums at once when rows are many
// Bins of one row a chunk copy brings, and chunks in the ring of each row.
// Each chunk costs the copier a fixed time, so R = kMelRows takes 2048-bin
// chunks in 4 slots (128 KB, one CTA an SM, 2 chunks of 4 rows in flight);
// R = 1 takes 1024-bin chunks in 16 slots, a whole default row (64 KB, two
// CTAs an SM).
template <int R>
constexpr int kMelChunk = R == 1 ? 1024 : 2048;
template <int R>
constexpr int kMelSlots = R == 1 ? 16 : 4;
// CTAs an SM should hold (the register budget): two for R = 1, so that the
// tick's 160 rows run as one wave on 132 SMs.
template <int R>
constexpr int kMelMinBlocks = R == 1 ? 2 : 1;

struct MelArgs {
  const float* power;       // (rows, n_bins)
  const int4* seg;          // band-major segments
  const int* band_first;    // (n_mels + 1)
  const int* work;          // segment indices by last bin: the warps' order
  const float* weights;
  float* out;               // (rows, n_mels)
  long long rows;
  int n_bins, n_mels, n_seg;
  int span_lo, span_hi;     // the bins any band covers
};

// Bins of row `row` that chunk k brings, in a ring of D chunks: the row's
// span [span_lo, span_hi) read from g0 = span_lo - sh, the 16-byte boundary
// at or before span_lo (sh = 0..3, as the row's base falls), in chunks of
// C = kMelChunk<R> bins: chunk k covers [g0 + kC, g0 + (k + 1)C) clipped to
// the span.  Its 16-byte-aligned middle comes by one bulk copy; the < 4 bins
// before the span's first boundary and after its last one by 4-byte
// cp.async.  No address outside the row's span is read.  Bin x of the row sits at
// ((base + x) & (D*C - 1)) of the row's ring, base = ((seq0 mod D) * C - g0)
// for the group whose chunk 0 is the CTA's chunk seq0.
struct MelChunk {
  int s, e;    // bins of the chunk inside the span
  int bs, be;  // its bulk-copied middle (be <= bs: none)
  int he, ts;  // scalar bins: the head [s, he), the tail [ts, e)

  __device__ __forceinline__ MelChunk(int g0, int k, int chunk, int span_lo, int span_hi) {
    const int ha = g0 == span_lo ? span_lo : g0 + 4;  // the span's first boundary
    const int ta = g0 + ((span_hi - g0) & ~3);         // and its last
    s = max(g0 + k * chunk, span_lo);
    e = min(g0 + (k + 1) * chunk, span_hi);
    bs = max(s, ha);
    be = min(e, ta);
    he = min(e, ha);
    ts = max(s, max(ha, ta));
  }
};

__device__ __forceinline__ int row_misalignment(const float* row, int span_lo) {
  return static_cast<int>((reinterpret_cast<unsigned long long>(row + span_lo) >> 2) & 3);
}

// The copying warp's work for chunk k of the R rows of group g, into ring
// slot `slot` (chunk seq of the CTA): lanes 0-3 copy the head bins, lanes
// 4-7 the tail bins, by cp.async; every lane's arrival on full follows its
// copies; lane 0 also arrives with the bulk bytes and issues the bulk
// copies.  No lane waits for device memory.
template <int R>
__device__ __forceinline__ void stage_chunk(const MelArgs& a, float* ring, unsigned long long* full,
                                            long long g, int k, long long seq, int lane) {
  constexpr int D = kMelSlots<R>;
  constexpr int C = kMelChunk<R>;
  constexpr int mask = D * C - 1;
  const int slot = static_cast<int>(seq % D);
  const int seq0_slot = static_cast<int>((seq - k) % D);
  unsigned bytes = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long row_index = g * R + r;
    if (row_index >= a.rows) break;
    const float* row = a.power + row_index * a.n_bins;
    const int g0 = a.span_lo - row_misalignment(row, a.span_lo);
    const MelChunk c(g0, k, C, a.span_lo, a.span_hi);
    float* dst = ring + r * D * C;
    const int base = seq0_slot * C - g0;
    int x = -1;
    if (lane < 4 && c.s + lane < c.he) x = c.s + lane;
    if (lane >= 4 && lane < 8 && c.ts + lane - 4 < c.e) x = c.ts + lane - 4;
    if (x >= 0) async_copy_4(dst + ((base + x) & mask), row + x);
    if (c.be > c.bs) bytes += 4u * (c.be - c.bs);
  }
  async_copy_arrive(full + slot);
  if (lane == 0) {
    mbar_arrive_expect_tx(full + slot, bytes);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long row_index = g * R + r;
      if (row_index >= a.rows) break;
      const float* row = a.power + row_index * a.n_bins;
      const int g0 = a.span_lo - row_misalignment(row, a.span_lo);
      const MelChunk c(g0, k, C, a.span_lo, a.span_hi);
      if (c.be > c.bs)
        bulk_copy(ring + r * D * C + ((seq0_slot * C - g0 + c.bs) & mask),
                  row + c.bs, 4u * (c.be - c.bs), full + slot);
    }
  }
}

// The lane's power bins of segment s in the ring, for R rows (kSegBins of
// them, past a short segment's end too): bin x of row r at (base[r] + x)
// mod D*C of the row's ring; where those bins do not wrap past the ring's
// end (nearly always) they are read at linear offsets.
template <int R, int D>
__device__ __forceinline__ void ring_bins(const float* ring, const int (&base)[R], int4 s,
                                          int lane, float (&x)[R][kSegSteps]) {
  constexpr int size = D * kMelChunk<R>;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float* row = ring + r * size;
    const int o = (base[r] + s.x) & (size - 1);
    if (o + kSegBins <= size) {
#pragma unroll
      for (int j = 0; j < kSegSteps; ++j) x[r][j] = row[o + lane + 32 * j];
    } else {
#pragma unroll
      for (int j = 0; j < kSegSteps; ++j) x[r][j] = row[(o + lane + 32 * j) & (size - 1)];
    }
  }
}

// Bytes of K2's dynamic shared memory: the full and empty barriers (8 bytes
// each per slot), the segments in the warps' order (16 each), band_first
// (padded to 16), the ring, and two buffers of R * n_seg segment sums.
template <int R>
constexpr long long mel_smem_bytes(int n_seg, int n_mels) {
  return 16LL * kMelSlots<R> + 16LL * n_seg + 16LL * ((n_mels + 4) / 4) +
         4LL * (R * kMelSlots<R> * kMelChunk<R> + 2LL * R * n_seg);
}

// K2: out[r, b] = band_db(band b's sum of power[r, :] * w_b), every row.
// One warp copies, kMelConsumerWarps warps sum.  A CTA first puts the
// segments (in the warps' order, work[], each with its band-major index)
// and band_first in shared memory, then walks groups of R rows (g =
// blockIdx.x, + gridDim.x, ...); each group's span comes as `chunks`
// chunks, chunk seq of the CTA into ring slot seq mod D, full[slot]
// completing when it has landed.  A segment whose last bin lies in chunk k
// (even in the worst alignment) is summed at step k from chunks k - 1 and k
// (a segment is shorter than a chunk), so a warp releases chunk k - 1
// (empty[slot]) once its step k is done and the copier refills the slot with
// chunk k - 1 + D.  Warp w takes segments w, w + W, ... of work[] in every
// group, each for all R rows at once; the sums go to seg_sums of the group
// (two buffers, by group parity); after a barrier of the summing warps, one
// thread per (row, band) adds the band's segments and writes out.
// kPasses: the product mode of the band sums (mel_fma): 0 f32, 1 and 3 the
// bf16x1 and bf16x3 tiers of sed_tpu's mel_precision.
template <int R, int kPasses>
__global__ void __launch_bounds__(kMelThreads, kMelMinBlocks<R>) mel_log_kernel(const MelArgs a) {
  constexpr int D = kMelSlots<R>;
  constexpr int C = kMelChunk<R>;
  constexpr int W = kMelConsumerWarps;
  extern __shared__ __align__(128) unsigned char mel_smem[];
  auto* full = reinterpret_cast<unsigned long long*>(mel_smem);
  auto* empty = full + D;
  int4* sseg = reinterpret_cast<int4*>(empty + D);
  int* sfirst = reinterpret_cast<int*>(sseg + a.n_seg);
  float* ring = reinterpret_cast<float*>(sfirst + 4 * ((a.n_mels + 4) / 4));
  float* seg_sums = ring + R * D * C;
  const long long groups = (a.rows + R - 1) / R;
  const int chunks = a.span_hi > a.span_lo ? (a.span_hi - a.span_lo + 2) / C + 1 : 0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < D; ++i) {
      mbar_init(full + i, 32 + 1);  // the copier's lanes' cp.async, its bulk bytes
      mbar_init(empty + i, W);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = threadIdx.x; i < a.n_seg; i += blockDim.x) {
    const int index = __ldg(a.work + i);
    int4 s = __ldg(a.seg + index);
    s.w = index;
    sseg[i] = s;
  }
  for (int b = threadIdx.x; b <= a.n_mels; b += blockDim.x) sfirst[b] = __ldg(a.band_first + b);
  __syncthreads();

  if (warp == W) {  // the copier
    long long seq = 0;
    for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
      for (int k = 0; k < chunks; ++k, ++seq) {
        if (seq >= D) mbar_wait(empty + seq % D, static_cast<unsigned>((seq / D - 1) & 1));
        stage_chunk<R>(a, ring, full, g, k, seq, lane);
      }
    }
    return;
  }

  // Segments a warp takes in every group: sseg[warp + W p], p < count.
  const int count = warp < a.n_seg ? (a.n_seg - 1 - warp) / W + 1 : 0;
  int4 s = count ? sseg[warp] : make_int4(0, 0, 0, 0);
  long long seq = 0;
  int parity = 0;
  for (long long g = blockIdx.x; g < groups; g += gridDim.x, parity ^= 1) {
    float* sums = seg_sums + parity * R * a.n_seg;
    int base[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long row_index = min(g * R + r, a.rows - 1);
      const float* row = a.power + row_index * a.n_bins;
      base[r] = static_cast<int>((seq % D) * C) - a.span_lo + row_misalignment(row, a.span_lo);
    }
    int done = 0;
    for (int k = 0; k < chunks; ++k, ++seq) {
      mbar_wait(full + seq % D, static_cast<unsigned>((seq / D) & 1));
      while (done < count && (s.x + s.y - 1 - a.span_lo + 3) / C == k) {
        const int4 next = sseg[warp + W * ((done + 1) % count)];
        float w[kSegSteps];
        segment_weights(a.weights, s, lane, w);
        float x[R][kSegSteps];
        ring_bins<R, D>(ring, base, s, lane, x);
        float sum[R];
        segment_sums<R, kPasses>(x, w, s.y, lane, sum);
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < R; ++r) sums[r * a.n_seg + s.w] = sum[r];
        }
        s = next;
        ++done;
      }
      __syncwarp();
      if (seq > 0 && lane == 0) mbar_arrive(empty + (seq - 1) % D);
    }
    asm volatile("bar.sync 1, %0;" ::"n"(32 * W) : "memory");
    const int n_rows = static_cast<int>(min(static_cast<long long>(R), a.rows - g * R));
    for (int t = threadIdx.x; t < n_rows * a.n_mels; t += 32 * W) {
      const int r = t / a.n_mels;
      const int b = t - r * a.n_mels;
      a.out[(g * R + r) * a.n_mels + b] =
          band_db(band_sum(sums + r * a.n_seg, sfirst[b], sfirst[b + 1]));
    }
  }
}

// K5's band epilogue over a cluster's power (ClusterPowerStore's, after its
// last cluster barrier): bin k of the frame at power[k / C] of CTA k mod C
// (bin m: CTA 0, power[M]).  The frame's C * 32 warps take the segments i =
// 32 r + warp, + 32 C, ..., each summed in K2's order (segment_sums at
// mel_passes, mel_fma) into CTA 0's seg_sums; after a cluster barrier CTA 0
// adds each band's segments (band_sum) and writes the row.  The bins and
// their order are K1's then K2's: equal to them bit for bit.
template <int C>
__device__ __forceinline__ void cluster_mel_log(int mel_passes, float* power,
                                                const int4* __restrict__ seg,
                                                const int* __restrict__ band_first,
                                                const float* __restrict__ weights,
                                                float* seg_sums, float* __restrict__ row,
                                                int n_mels, int n_seg, int m) {
  cg::cluster_group cluster = cg::this_cluster();
  const int r = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  float* sums = cluster.map_shared_rank(seg_sums, 0);
  for (int i = r * n_warps + (threadIdx.x >> 5); i < n_seg; i += C * n_warps) {
    const int4 s = __ldg(seg + i);
    float w[kSegSteps];
    segment_weights(weights, s, lane, w);
    // The lane's bins (past a short segment's end, bin m: left out of the sum).
    float x[1][kSegSteps];
#pragma unroll
    for (int j = 0; j < kSegSteps; ++j) {
      const int k = min(s.x + lane + 32 * j, m);
      x[0][j] = *cluster.map_shared_rank(power + k / C, k & (C - 1));
    }
    float sum[1];
    switch (mel_passes) {
      case 1: segment_sums<1, 1>(x, w, s.y, lane, sum); break;
      case 3: segment_sums<1, 3>(x, w, s.y, lane, sum); break;
      default: segment_sums<1, 0>(x, w, s.y, lane, sum);
    }
    if (lane == 0) sums[i] = sum[0];
  }
  cluster.sync();
  if (r == 0)
    for (int b = threadIdx.x; b < n_mels; b += blockDim.x)
      row[b] = band_db(band_sum(seg_sums, __ldg(band_first + b), __ldg(band_first + b + 1)));
}

template <int LOG2_M>
__global__ void __launch_bounds__(kStockhamThreads<LOG2_M>, 1)
wave_stft_mel_log_kernel(const float* __restrict__ wave,
                         const float* __restrict__ window,
                         const float2* __restrict__ twiddle,  // stockham_twiddles
                         const float2* __restrict__ unpack,   // W_N^k, k < m
                         const int4* __restrict__ seg,
                         const int* __restrict__ band_first,
                         const float* __restrict__ weights,
                         float* __restrict__ out,
                         long long n_samples, int n_frames, int hop, int n_mels, int n_seg,
                         int mel_passes) {
  // re: m floats, im: m floats, the power: m + 1 floats, the segment sums:
  // n_seg floats, then kSegBins floats that a short segment's loads may
  // reach past the power row.
  extern __shared__ float exchange[];
  constexpr int m = 1 << LOG2_M;
  constexpr int C = kClusterCtas<LOG2_M>;
  if constexpr (C == 1) {
    float* power = exchange + 2 * m;
    const auto load = frame_load<LOG2_M>(wave, window, n_samples, n_frames, hop, exchange,
                                          blockIdx.x);
    const PowerStore store{power, unpack, exchange, exchange + m};
    stockham_fft<LOG2_M>(load, store, twiddle, exchange, exchange + m);
    __syncthreads();
    float* row = out + blockIdx.x * static_cast<long long>(n_mels);
    constexpr bool kWarps = kStockhamThreads<LOG2_M> >= 32;
    mel_log_row_mode<kWarps>(mel_passes, power, seg, band_first, weights, power + m + 1, row,
                             n_mels, n_seg);
  } else {
    // A cluster: CTA r keeps the power of its bins r + C k1 at power[k1]
    // (CTA 0 bin m at power[M]), then the frame's warps sum K2's segments
    // as K5t's do, each bin read from the CTA that holds it (bin k: CTA k
    // mod C, k / C), the sums into CTA 0's seg_sums; CTA 0 adds the bands.
    constexpr int M = m / C;
    const long long frame = blockIdx.x / C;
    const int r = static_cast<int>(blockIdx.x % C);
    float* power = exchange + 2 * M;  // M + 1 floats
    float* seg_sums = power + M + 1;  // n_seg floats (CTA 0's)
    const CrossLoad<C, PackedWaveLoad> load{
        frame_load<LOG2_M>(wave, window, n_samples, n_frames, hop, exchange, frame, r * M, M),
        twiddle + M, exchange, exchange + M};
    const ClusterPowerStore<C> store{power, 1, power + M, unpack, exchange, exchange + M};
    stockham_fft<kCtaLog2M>(load, store, twiddle, exchange, exchange + M);
    cluster_mel_log<C>(mel_passes, power, seg, band_first, weights, seg_sums,
                       out + frame * n_mels, n_mels, n_seg, m);
  }
}

template <int LOG2_M>
__global__ void __launch_bounds__(kStockhamThreads<LOG2_M>, 1)
wave_packed_fft_kernel(const float* __restrict__ wave,
                       const float* __restrict__ window,
                       const float2* __restrict__ twiddle,  // stockham_twiddles
                       float* __restrict__ out_re,
                       float* __restrict__ out_im,
                       long long n_samples, int n_frames, int hop) {
  extern __shared__ float exchange[];  // re: m floats, then im: m floats (M: a cluster's CTA)
  constexpr int m = 1 << LOG2_M;
  constexpr int C = kClusterCtas<LOG2_M>;
  if constexpr (C == 1) {
    const auto load = frame_load<LOG2_M>(wave, window, n_samples, n_frames, hop, exchange,
                                          blockIdx.x);
    const long long frame = blockIdx.x;
    const SplitStore store{out_re + frame * m, out_im + frame * m};
    stockham_fft<LOG2_M>(load, store, twiddle, exchange, exchange + m);
  } else {
    constexpr int M = m / C;
    const long long frame = blockIdx.x / C;
    const int r = static_cast<int>(blockIdx.x % C);
    const CrossLoad<C, PackedWaveLoad> load{
        frame_load<LOG2_M>(wave, window, n_samples, n_frames, hop, exchange, frame, r * M, M),
        twiddle + M, exchange, exchange + M};
    const ClusterSplitStore<C> store{out_re + frame * m, out_im + frame * m};
    stockham_fft<kCtaLog2M>(load, store, twiddle, exchange, exchange + M);
  }
}

// A kernel over stockham_fft at m = 2^LOG2_M: kStockhamThreads threads a
// block; in dynamic shared memory the 2m floats of the exchange buffer (2M,
// M = m / C, in each CTA of a cluster), then extra_smem bytes of the
// kernel's own.  Above 2^14 points each of the `blocks` frames (rows) is a
// cluster of kClusterCtas CTAs, launched by cudaLaunchKernelEx with its
// cluster dimension; cudaErrorInvalidConfiguration when no such cluster fits
// on the card (cudaOccupancyMaxActiveClusters, read once a kernel, device and
// size: kept per device as smem << 32 | clusters in an atomic, so that
// threads launching at once on any card each read a whole entry; devices
// past the cache's 16 ask every launch).
template <int LOG2_M, typename... Params, typename... Args>
int launch_stockham(void (*kernel)(Params...), long long blocks, int extra_smem,
                    cudaStream_t stream, const Args&... args) {
  constexpr int threads = kStockhamThreads<LOG2_M>;
  constexpr int C = kClusterCtas<LOG2_M>;
  constexpr int kLog2Cta = LOG2_M < kCtaLog2M ? LOG2_M : kCtaLog2M;  // the CTA's points
  const int smem = static_cast<int>(sizeof(float2) << kLog2Cta) + extra_smem;
  if (smem > 232448 || blocks * C > 2147483647LL) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if constexpr (C == 1) {
    kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(args...);
  } else {
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(static_cast<unsigned>(blocks * C));
    config.blockDim = dim3(threads);
    config.dynamicSmemBytes = static_cast<size_t>(smem);
    config.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    static std::atomic<long long> fits_at[16];  // per device: smem << 32 | clusters
    int device = 0, fits = 0;
    err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    const long long cached = device < 16 ? fits_at[device].load(std::memory_order_relaxed) : 0;
    if (cached >> 32 == smem) {
      fits = static_cast<int>(cached & 0xffffffffLL);
    } else {
      err = cudaOccupancyMaxActiveClusters(&fits, kernel, &config);
      if (err != cudaSuccess) return err;
      if (device < 16)
        fits_at[device].store(static_cast<long long>(smem) << 32 | fits,
                              std::memory_order_relaxed);
    }
    if (fits == 0) return cudaErrorInvalidConfiguration;
    err = cudaLaunchKernelEx(&config, kernel, args...);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// launch(std::integral_constant<int, log2_m>{}) for log2 m 1..16 (n_fft
// 4..131072; above 14 a cluster of 2 or 4 CTAs a frame), which instantiates
// `launch` once for each; cudaErrorInvalidValue for any other log2 m.
template <typename Launch, int... L>
int with_log2_m(int log2_m, const Launch& launch, std::integer_sequence<int, L...>) {
  int err = cudaErrorInvalidValue;
  (void)((log2_m == L + 1 ? (err = launch(std::integral_constant<int, L + 1>{}), true)
                          : false) || ...);
  return err;
}

template <typename Launch>
int with_log2_m(int log2_m, const Launch& launch) {
  return with_log2_m(log2_m, launch, std::make_integer_sequence<int, 16>{});
}

// K2 over R rows at a time: the ring (R rows of kMelSlots<R> chunks), two
// buffers of R * n_seg segment sums, the barriers before them; as many
// persistent CTAs as fit on the card at once, or one per group of rows.
template <int R, int kPasses = 0>
int launch_mel_log(const MelArgs& args, int n_sm, cudaStream_t stream) {
  const long long bytes = mel_smem_bytes<R>(args.n_seg, args.n_mels);
  if (bytes > 232448) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(bytes);
  cudaError_t err = cudaFuncSetAttribute(mel_log_kernel<R, kPasses>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mel_log_kernel<R, kPasses>,
                                                      kMelThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long groups = (args.rows + R - 1) / R;
  const long long ctas = groups < 1LL * per_sm * n_sm ? groups : 1LL * per_sm * n_sm;
  mel_log_kernel<R, kPasses><<<static_cast<unsigned>(ctas), kMelThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K1t, K3t, K5t, K6t: the bf16 tensor-core DFT of the reduced-precision
// tiers.  sed_tpu's two-stage matmul DFT (n = n1 * n2, stft.py
// _matmul_fft_constants) with every product split into bf16 chunks as its
// _make_dot does, on wgmma: K1t and K3t (K5t's first part) by the split
// pass and tier_fused_kernel<P1, P2, N1> or the tier GEMMs (further down),
// K6t by tier_packed_fft_kernel<N1, P1, P2>.
// ---------------------------------------------------------------------------

// bf16 chunks an operand is split into at P passes (1: bf16x1; 3, 4:
// bf16x3, bf16x4, hi and lo; 6: bf16x6, three chunks), and whether the
// product of chunk ca of one operand and chunk cb of the other is one of
// its terms: x1 (0,0); x3 adds (0,1), (1,0); x4 (1,1); x6 (2,0), (0,2).
__host__ __device__ constexpr int tier_chunks(int passes) {
  return passes == 1 ? 1 : (passes == 6 ? 3 : 2);
}
__host__ __device__ constexpr bool tier_term(int passes, int ca, int cb) {
  return passes == 1   ? ca + cb == 0
         : passes == 3 ? ca + cb <= 1
         : passes == 4 ? ca <= 1 && cb <= 1
                       : ca + cb <= 2;
}

// v split into C bf16 chunks by round to nearest even: c[0] = bf16(v),
// c[i] = bf16(v - c[0] - ... - c[i-1]), each residual exact in f32.  It is
// sed_tpu's _split_bf16 (hi = bf16(a), lo = a - hi; three chunks as its
// _split3), with each chunk rounded to bf16 as the TPU's matrix unit rounds
// an operand at Precision.DEFAULT.
template <int C>
__device__ __forceinline__ void split_bf16(float v, __nv_bfloat16 (&c)[C]) {
#pragma unroll
  for (int i = 0; i < C; ++i) {
    c[i] = __float2bfloat16_rn(v);
    v -= __bfloat162float(c[i]);
  }
}

template <int C>
__device__ __forceinline__ void split_bf16x2(float v0, float v1, unsigned (&c)[C]) {
  __nv_bfloat16 a[C], b[C];
  split_bf16<C>(v0, a);
  split_bf16<C>(v1, b);
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const __nv_bfloat162 pair = __halves2bfloat162(a[i], b[i]);
    c[i] = *reinterpret_cast<const unsigned*>(&pair);
  }
}

// Where a block's frame comes from, and its samples times the window, read
// only where the window is non-zero (as K1's and K3's loaders read them).
// kind 0: K1's centred frame of a waveform, reflect-padded on the index
// (frame_load's start and interior test, reflect_index); 1: K3's rows of
// f32 samples; 2: K3's rows of int16 PCM, the window pre-scaled by 1/32768.
struct TierSource {
  const void* data;
  const float* window;
  long long n_samples;  // kind 0: samples of a signal
  int n_frames, hop;    // kind 0
  int kind;
};

struct TierFrame {
  const float* y;    // kind 0: the signal; 1: the row
  const short* y16;  // kind 2: the row
  const float* window;
  long long start, n;
  bool interior;
  int kind;

  __device__ __forceinline__ TierFrame(const TierSource& src, long long row, int n_fft) {
    window = src.window;
    kind = src.kind;
    y16 = nullptr;
    start = 0;
    n = n_fft;
    interior = true;
    if (kind == 0) {
      const long long sig = row / src.n_frames;
      y = static_cast<const float*>(src.data) + sig * src.n_samples;
      start = (row - sig * src.n_frames) * src.hop - n_fft / 2;
      n = src.n_samples;
      interior = start >= 0 && start + n_fft <= n;
    } else if (kind == 1) {
      y = static_cast<const float*>(src.data) + row * n_fft;
    } else {
      y = nullptr;
      y16 = static_cast<const short*>(src.data) + row * n_fft;
    }
  }

  // Samples s and s + 1 (s even), unwindowed: every load is issued without
  // waiting for the window (windowed() applies it as K1 and K3 do).
  __device__ __forceinline__ float2 raw(int s) const {
    if (kind == 0) {
      if (interior) return make_float2(__ldg(y + start + s), __ldg(y + start + s + 1));
      return make_float2(__ldg(y + reflect_index(start + s, n)),
                         __ldg(y + reflect_index(start + s + 1, n)));
    }
    if (kind == 1) return __ldg(reinterpret_cast<const float2*>(y) + (s >> 1));
    const short2 q = __ldg(reinterpret_cast<const short2*>(y16) + (s >> 1));
    return make_float2(static_cast<float>(q.x), static_cast<float>(q.y));
  }
};

// x times the window w, 0 where the window is 0 (K1's and K3's loaders).
__device__ __forceinline__ float2 windowed(float2 x, float2 w) {
  return make_float2(w.x != 0.f ? w.x * x.x : 0.f, w.y != 0.f ? w.y * x.y : 0.f);
}

// Packed point j = (x[2j], x[2j+1]) of a frame times the window, 0 where the
// window is 0 (the values of K1's and K3's loaders).
__device__ __forceinline__ float2 packed_point(const TierFrame& frame, const float2* window,
                                               int j) {
  return windowed(frame.raw(2 * j), __ldg(window + j));
}

// |Z|^2 as sed_tpu's zr zr + zi zi, no fused multiply-add.
__device__ __forceinline__ float tier_power(float zr, float zi) {
  return __fadd_rn(__fmul_rn(zr, zr), __fmul_rn(zi, zi));
}

// ---------------------------------------------------------------------------
// K6t: tier_packed_fft_kernel<N1, P1, P2>, sed_tpu's matmul DFT of the packed
// frame on wgmma.  See the header note; its tables' layout is modelled by
// tests/test_torch_packed_tiers.py against the plain version.
// ---------------------------------------------------------------------------

// Byte offset of element (r, c), c < 64, of a tile of bf16 rows of 64 (128
// bytes) under the 128-byte swizzle wgmma reads (16-byte chunk c / 8 of row r
// at chunk (c / 8) ^ (r mod 8)); a tile starts on a 1024-byte boundary.
__host__ __device__ constexpr int sw128(int r, int c) {
  return r * 128 + ((((c >> 3) ^ (r & 7))) << 4) + (c & 7) * 2;
}

// The matrix descriptor of a K-major tile at shared address `addr` (rows of
// 128 bytes, 128-byte swizzle, 8-row groups 1024 bytes apart), advanced to
// its k16 step j (32 bytes a step inside the swizzled row).
__device__ __forceinline__ unsigned long long sw128_desc(unsigned addr, int j) {
  return static_cast<unsigned long long>(((addr + 32 * j) >> 4) & 0x3FFF) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous products that write it.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Generic-proxy stores to shared memory made visible to wgmma (async proxy).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;" ::"r"(smem_address(bar)),
               "r"(bytes)
               : "memory");
}

// d += A B by wgmma.mma_async.m64nNk16 (bf16 in, f32 out), A (64 x 16) and B
// (N x 16) K-major in shared memory by descriptor.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float (&d)[4], unsigned long long a,
                                             unsigned long long b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], unsigned long long a,
                                             unsigned long long b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], unsigned long long a,
                                             unsigned long long b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15} "
        ", %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], unsigned long long a,
                                             unsigned long long b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31} "
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], unsigned long long a,
                                             unsigned long long b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63} "
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

constexpr int kPackedRing2 = 2;  // stage 2's ring of W1 tiles
// Threads of an instance: warpgroup 0 multiplies, the others produce (two
// where a pass has 64 or more columns, so that twice the loads are in flight).
__host__ __device__ constexpr int packed_producers(int n1p) { return n1p >= 64 ? 256 : 128; }
__host__ __device__ constexpr int packed_threads(int n1p) { return 128 + packed_producers(n1p); }

// The shape of an instance: k2 rows a unit (kb), stage 1's columns a pass
// (n1p; n1 / n1p passes), stage 1's ring slots (d1), and its dynamic shared
// memory in bytes (1024 of it the base's alignment).  The largest kb (64 up
// to n1 128, else 32), n1p (up to 128) and d1 (3 or 2), in that order, whose
// sum fits 227 KB: 103-230 KB at every (n1, C1, C2).  Only the kernel and
// its launch read it: the host's tables do not depend on it
// (cuda_featurizer.packed_plan repeats it for launch_plan's report).
struct PackedShape {
  int kb, n1p, d1, smem;
};
__host__ __device__ constexpr int packed_smem(int n1, int c1, int c2, int kb, int n1p, int d1) {
  return c2 * (2 * n1 / 64) * kb * 128          // T^T, C2 chunks
         + d1 * c1 * (n1p + 2 * kb) * 128        // ring 1: X and A1 tiles
         + kPackedRing2 * c2 * 64 * 128          // ring 2: A2 tiles
         + 2 * 32 * (kb + 4) * 4                 // the drain's Zr and Zi rows
         + 2 * 8 * (3 + kPackedRing2)            // the rings' barriers
         + 1024;
}
__host__ __device__ constexpr PackedShape packed_shape(int n1, int p1, int p2) {
  const int c1 = tier_chunks(p1), c2 = tier_chunks(p2);
  for (int kb = n1 <= 128 ? 64 : 32; kb >= 32; kb -= 32)
    for (int n1p = n1 < 128 ? n1 : 128; n1p >= 32; n1p /= 2)
      for (int d1 = 3; d1 >= 2; --d1)
        if (packed_smem(n1, c1, c2, kb, n1p, d1) <= 232448)
          return {kb, n1p, d1, packed_smem(n1, c1, c2, kb, n1p, d1)};
  return {0, 0, 0, 0};
}

// K6t.  A unit is (frame, kb k2 rows: k0 = kb * blk); persistent CTAs walk
// units u = blockIdx.x, + gridDim.x, ...  Warpgroup 1 produces, warpgroup 0
// consumes, through two rings of shared memory whose slots complete on
// mbarriers:
//   ring 1 (stage 1, d1 slots): a K tile of 64 columns, Re z at 32 a then Im
//     z at the same a (a = 32 kt ..), as X's C1 chunks (n1p rows b of the
//     pass, K-major: written by the producer's threads, which load, window
//     and split the frame's samples straight into the swizzled B layout) and
//     W2's C1 chunks of each of the unit's kb / 32 M tiles of 64 rows (Yr,
//     Yi interleaved by 8: one bulk copy, cp.async.bulk, of the host's
//     image a tile);
//   ring 2 (stage 2, 2 slots): W1's C2 chunks of a 64-row M tile (k1, Zr and
//     Zi interleaved by 8) and a K tile (one bulk copy).
// The consumer: stage 1, [Yr; Yi] = W2 [Xr; Xi] (m64 n(n1p) k16, kb / 32 M
// tiles, A and B by descriptor) over the pass's n1p columns; the twiddle T
// = Y * W_m^(k2 b) in f32 in registers (sed_tpu's order, no fused
// multiply-add), split into C2 chunks, into T^T (kb rows k2, K = [Tr | Ti]
// over b); after n1 / n1p passes, stage 2 in M tiles of 64: Z^T = W1^T T^T
// (m64 n(kb) k16), each tile's (Zr, Zi) rows through shared memory to 16-byte
// stores of kb contiguous bins n2 k1 + k0 .. of out_re and out_im.
template <int N1, int P1, int P2>
__global__ void __launch_bounds__(packed_threads(packed_shape(N1, P1, P2).n1p), 1)
tier_packed_fft_kernel(const TierSource src, const __nv_bfloat16* __restrict__ tab1,
                  const __nv_bfloat16* __restrict__ tab2, const float2* __restrict__ twiddle,
                  float* __restrict__ out_re, float* __restrict__ out_im, int n2,
                  long long units) {
  constexpr PackedShape kShape = packed_shape(N1, P1, P2);
  constexpr int C1 = tier_chunks(P1), C2 = tier_chunks(P2);
  constexpr int KB = kShape.kb, N1P = kShape.n1p, D1 = kShape.d1, D2 = kPackedRing2;
  constexpr int NH = N1 / N1P;        // stage 1's passes
  constexpr int MT1 = KB / 32;        // stage 1's M tiles (32 k2 rows, Yr and Yi)
  constexpr int KT2 = 2 * N1 / 64;    // stage 2's K tiles (and M tiles of 64 rows)
  constexpr int A1_TILE = C1 * 64 * 128;  // W2's C1 chunks of a 64-row M tile
  constexpr int X_BYTES = C1 * N1P * 128, A1_BYTES = MT1 * A1_TILE;
  constexpr int S1 = X_BYTES + A1_BYTES, S2 = C2 * 64 * 128;
  constexpr int T_BYTES = C2 * KT2 * KB * 128;
  constexpr int DS = KB + 4;          // the drain's row stride, floats
  constexpr int PT = packed_producers(N1P);
  static_assert(KB > 0 && NH * N1P == N1, "tier_packed_fft_kernel: shape");
  extern __shared__ __align__(16) unsigned char packed_smem_raw[];
  unsigned char* smem =
      packed_smem_raw + ((1024 - (smem_address(packed_smem_raw) & 1023)) & 1023);
  unsigned char* tts = smem;                         // T^T
  unsigned char* ring1 = tts + T_BYTES;              // D1 slots of S1
  unsigned char* ring2 = ring1 + D1 * S1;            // D2 slots of S2
  float* drain = reinterpret_cast<float*>(ring2 + D2 * S2);  // [2][32][DS]
  auto* full1 = reinterpret_cast<unsigned long long*>(drain + 2 * 32 * DS);
  auto* empty1 = full1 + D1;
  auto* full2 = empty1 + D1;
  auto* empty2 = full2 + D2;
  const int m = N1 * n2;
  const int blocks = n2 / KB;   // units a frame
  const int kt1_count = n2 / 32;  // stage 1's K tiles
  if (threadIdx.x == 0) {
    for (int i = 0; i < D1; ++i) {
      mbar_init(full1 + i, PT);   // the producer's threads; the bulk bytes by expect_tx
      mbar_init(empty1 + i, 4);   // the consumer's warps
    }
    for (int i = 0; i < D2; ++i) {
      mbar_init(full2 + i, 1);
      mbar_init(empty2 + i, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // With two producing warpgroups (384 threads, 168 registers each at
  // launch) the producers give registers up to the multiplying warpgroup,
  // whose stage-1 sums take 128 of them.
  if (threadIdx.x >= 128) {  // ---- the producers ----
    if constexpr (PT == 256) asm volatile("setmaxnreg.dec.sync.aligned.u32 120;" ::: "memory");
    // Steps (unit u, pass h, K tile kt) in the consumer's order.  A step's
    // items (octet o, row b): points z[a n1 + b] for a = 32 kt + 8 o .. + 7,
    // windowed and split as one 16-byte chunk of Re and one of Im in each of
    // X's C1 chunks.  A step's samples and window pairs are loaded a step
    // ahead, all of them before any is used, so that their latency passes
    // while the producer waits for the slot and splits the step before.
    constexpr int ITEMS = 4 * N1P / PT;
    const int pt = threadIdx.x - 128;
    const auto* window = reinterpret_cast<const float2*>(src.window);
    float2 xs[ITEMS][8], ws[ITEMS][8];
    const auto load_step = [&](const TierFrame& frame, int h, int kt) {
      // An interior frame whose start is 8-byte aligned: one load a point.
      const float2* pairs = reinterpret_cast<const float2*>(frame.y + frame.start);
      const bool paired =
          frame.interior && (reinterpret_cast<unsigned long long>(pairs) & 7) == 0;
#pragma unroll
      for (int it = 0; it < ITEMS; ++it) {
        const int q = pt + PT * it;
        const int b = q % N1P, o = q / N1P;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int j = (32 * kt + 8 * o + e) * N1 + h * N1P + b;
          xs[it][e] = paired ? __ldg(pairs + j) : frame.raw(2 * j);
          ws[it][e] = __ldg(window + j);
        }
      }
    };
    long long u = blockIdx.x, seq1 = 0, seq2 = 0;
    int h = 0, kt = 0;
    TierFrame frame(src, u < units ? u / blocks : 0, 2 * m);  // the unit's, built once a unit
    if (u < units) load_step(frame, h, kt);
    int blk = static_cast<int>(u % blocks);
    while (u < units) {
      const int slot = static_cast<int>(seq1 % D1);
      if (seq1 >= D1) mbar_wait(empty1 + slot, static_cast<unsigned>((seq1 / D1 - 1) & 1));
      unsigned char* x = ring1 + slot * S1;
      if (pt == 0) {
        mbar_expect_tx(full1 + slot, A1_BYTES);
#pragma unroll
        for (int mt = 0; mt < MT1; ++mt)
          bulk_copy(reinterpret_cast<float*>(x + X_BYTES + mt * A1_TILE),
                    reinterpret_cast<const float*>(
                        tab1 + ((static_cast<long long>(blk) * MT1 + mt) * kt1_count + kt) *
                                   C1 * 64 * 64),
                    A1_TILE, full1 + slot);
      }
#pragma unroll
      for (int it = 0; it < ITEMS; ++it) {
        const int q = pt + PT * it;
        const int b = q % N1P, o = q / N1P;
        // Re (part 0) and Im (part 1) of the 8 points as 4 pairs, split a
        // chunk at a time by one cvt.rn.bf16x2 a pair (split_bf16's
        // rounding, the residuals exact in f32).
        float2 v[2][4];
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          const float2 z0 = windowed(xs[it][e], ws[it][e]);
          const float2 z1 = windowed(xs[it][e + 1], ws[it][e + 1]);
          v[0][e / 2] = make_float2(z0.x, z1.x);
          v[1][e / 2] = make_float2(z0.y, z1.y);
        }
#pragma unroll
        for (int part = 0; part < 2; ++part) {
#pragma unroll
          for (int ci = 0; ci < C1; ++ci) {
            uint4 w;
            unsigned* wp = reinterpret_cast<unsigned*>(&w);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const __nv_bfloat162 pair = __float22bfloat162_rn(v[part][e]);
              wp[e] = *reinterpret_cast<const unsigned*>(&pair);
              if (ci + 1 < C1) {
                const float2 f = __bfloat1622float2(pair);
                v[part][e] = make_float2(v[part][e].x - f.x, v[part][e].y - f.y);
              }
            }
            *reinterpret_cast<uint4*>(x + ci * N1P * 128 + sw128(b, 32 * part + 8 * o)) = w;
          }
        }
      }
      fence_async_shared();
      mbar_arrive(full1 + slot);
      ++seq1;
      // The next step, whose loads fly from here on.
      const long long u_step = u;
      if (++kt == kt1_count) {
        kt = 0;
        if (++h == NH) {
          h = 0;
          u += gridDim.x;
          if (u < units) {
            frame = TierFrame(src, u / blocks, 2 * m);
            blk = static_cast<int>(u % blocks);
          }
        }
      }
      if (u < units) load_step(frame, h, kt);
      if (u != u_step && pt == 0) {  // the finished unit's W1 tiles, stage 2's
        for (int mt = 0; mt < KT2; ++mt) {
          for (int k2t = 0; k2t < KT2; ++k2t, ++seq2) {
            const int slot2 = static_cast<int>(seq2 % D2);
            if (seq2 >= D2) mbar_wait(empty2 + slot2, static_cast<unsigned>((seq2 / D2 - 1) & 1));
            mbar_arrive_expect_tx(full2 + slot2, S2);
            bulk_copy(reinterpret_cast<float*>(ring2 + slot2 * S2),
                      reinterpret_cast<const float*>(
                          tab2 + (static_cast<long long>(mt) * KT2 + k2t) * C2 * 64 * 64),
                      S2, full2 + slot2);
          }
        }
      }
    }
    return;
  }

  // ---- the consumer ----
  if constexpr (PT == 256) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tig = lane & 3;
  const unsigned tts_addr = smem_address(tts), ring1_addr = smem_address(ring1),
                 ring2_addr = smem_address(ring2);
  long long seq1 = 0, seq2 = 0;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const long long row = u / blocks;
    const int blk = static_cast<int>(u - row * blocks);
    const int k0 = KB * blk;
    // Stage 1, a pass of N1P columns b at a time, then its T^T columns.
    for (int h = 0; h < NH; ++h) {
      float acc[MT1][N1P / 2];
#pragma unroll
      for (int mt = 0; mt < MT1; ++mt)
#pragma unroll
        for (int i = 0; i < N1P / 2; ++i) acc[mt][i] = 0.f;
      int prev = -1;
      for (int kt = 0; kt < kt1_count; ++kt, ++seq1) {
        const int slot = static_cast<int>(seq1 % D1);
        mbar_wait(full1 + slot, static_cast<unsigned>((seq1 / D1) & 1));
        const unsigned x = ring1_addr + slot * S1, a = x + X_BYTES;
#pragma unroll
        for (int mt = 0; mt < MT1; ++mt) fence_operands(acc[mt]);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int ca = 0; ca < C1; ++ca)
#pragma unroll
            for (int cb = 0; cb < C1; ++cb) {
              if (!tier_term(P1, ca, cb)) continue;
#pragma unroll
              for (int mt = 0; mt < MT1; ++mt)
                Wgmma<N1P>::mma(acc[mt], sw128_desc(a + mt * A1_TILE + ca * 64 * 128, j),
                                sw128_desc(x + cb * N1P * 128, j));
            }
        wgmma_commit();
#pragma unroll
        for (int mt = 0; mt < MT1; ++mt) fence_operands(acc[mt]);
        wgmma_wait<1>();
        if (prev >= 0 && lane == 0) mbar_arrive(empty1 + prev);
        prev = slot;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < MT1; ++mt) fence_operands(acc[mt]);
      if (lane == 0) mbar_arrive(empty1 + prev);
      // The twiddle (acc[mt][4i ..]: yr(b), yr(b + 1), yi(b), yi(b + 1) at
      // k2 row 32 mt + 8 warp + g), split, into T^T: Tr at K = b, Ti at n1 + b.
#pragma unroll
      for (int mt = 0; mt < MT1; ++mt) {
        const int k2l = 32 * mt + 8 * warp + g;
#pragma unroll
        for (int i = 0; i < N1P / 8; ++i) {
          const int b = h * N1P + 8 * i + 2 * tig;
          const float4 tw = *reinterpret_cast<const float4*>(
              twiddle + static_cast<long long>(k0 + k2l) * N1 + b);
          const float* y = acc[mt] + 4 * i;
          const float tr0 = __fsub_rn(__fmul_rn(y[0], tw.x), __fmul_rn(y[2], tw.y));
          const float ti0 = __fadd_rn(__fmul_rn(y[0], tw.y), __fmul_rn(y[2], tw.x));
          const float tr1 = __fsub_rn(__fmul_rn(y[1], tw.z), __fmul_rn(y[3], tw.w));
          const float ti1 = __fadd_rn(__fmul_rn(y[1], tw.w), __fmul_rn(y[3], tw.z));
          unsigned cr[C2], cim[C2];
          split_bf16x2<C2>(tr0, tr1, cr);
          split_bf16x2<C2>(ti0, ti1, cim);
#pragma unroll
          for (int c = 0; c < C2; ++c) {
            *reinterpret_cast<unsigned*>(tts + ((c * KT2 + (b >> 6)) * KB) * 128 +
                                         sw128(k2l, b & 63)) = cr[c];
            *reinterpret_cast<unsigned*>(tts + ((c * KT2 + ((N1 + b) >> 6)) * KB) * 128 +
                                         sw128(k2l, (N1 + b) & 63)) = cim[c];
          }
        }
      }
    }
    fence_async_shared();
    asm volatile("bar.sync 1, 128;" ::: "memory");  // T^T is written

    // Stage 2 in M tiles of 64 rows (k1 = 32 mt + 8 warp + g; Zr, Zi), two
    // accumulators in turn: tile mt's drain runs while tile mt + 1's first
    // products do (after wgmma_wait<1> at that step, tile mt's are done).
    const long long base = row * m + k0;
    const auto drain_tile = [&](int mt, float (&acc2)[KB / 2]) {
      // Rows k1 (Zr plane 0, Zi plane 1) of kb bins k2 through shared
      // memory, then 16-byte stores of the bins n2 k1 + k0 ...
      fence_operands(acc2);
      asm volatile("bar.sync 1, 128;" ::: "memory");  // the last tile's rows are read
      const int k1l = 8 * warp + g;
#pragma unroll
      for (int i = 0; i < KB / 8; ++i) {
        const int n = 8 * i + 2 * tig;
        *reinterpret_cast<float2*>(drain + k1l * DS + n) = make_float2(acc2[4 * i], acc2[4 * i + 1]);
        *reinterpret_cast<float2*>(drain + (32 + k1l) * DS + n) =
            make_float2(acc2[4 * i + 2], acc2[4 * i + 3]);
      }
      asm volatile("bar.sync 1, 128;" ::: "memory");
#pragma unroll
      for (int i = 0; i < 2 * 32 * KB / 4 / 128; ++i) {
        const int q = t + 128 * i;
        const int plane = q / (32 * KB / 4);
        const int r = (q / (KB / 4)) % 32;
        const int c4 = q % (KB / 4);
        const float4 v = *reinterpret_cast<const float4*>(drain + (32 * plane + r) * DS + 4 * c4);
        float* out = plane ? out_im : out_re;
        *reinterpret_cast<float4*>(out + base + static_cast<long long>(32 * mt + r) * n2 +
                                   4 * c4) = v;
      }
    };
    float acc2[2][KB / 2];
    int prev = -1;
#pragma unroll
    for (int mt = 0; mt < KT2; ++mt) {
#pragma unroll
      for (int i = 0; i < KB / 2; ++i) acc2[mt & 1][i] = 0.f;
#pragma unroll 1
      for (int kt = 0; kt < KT2; ++kt, ++seq2) {
        const int slot = static_cast<int>(seq2 % D2);
        mbar_wait(full2 + slot, static_cast<unsigned>((seq2 / D2) & 1));
        const unsigned a = ring2_addr + slot * S2;
        fence_operands(acc2[mt & 1]);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int ca = 0; ca < C2; ++ca)
#pragma unroll
            for (int cb = 0; cb < C2; ++cb) {
              if (!tier_term(P2, ca, cb)) continue;
              Wgmma<KB>::mma(acc2[mt & 1], sw128_desc(a + ca * 64 * 128, j),
                             sw128_desc(tts_addr + (cb * KT2 + kt) * KB * 128, j));
            }
        wgmma_commit();
        fence_operands(acc2[mt & 1]);
        wgmma_wait<1>();
        if (prev >= 0 && lane == 0) mbar_arrive(empty2 + prev);
        prev = slot;
        if (mt > 0 && kt == 0) drain_tile(mt - 1, acc2[(mt - 1) & 1]);
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty2 + prev);
    drain_tile(KT2 - 1, acc2[(KT2 - 1) & 1]);
  }
}

// launch(integral_constant<P>) for P = passes in 1, 3, 4, 6.
template <typename Launch>
int with_passes(int passes, const Launch& launch) {
  switch (passes) {
    case 1: return launch(std::integral_constant<int, 1>{});
    case 3: return launch(std::integral_constant<int, 3>{});
    case 4: return launch(std::integral_constant<int, 4>{});
    case 6: return launch(std::integral_constant<int, 6>{});
    default: return cudaErrorInvalidValue;
  }
}

template <int kLo, typename AtN1, int... I>
int with_tier_n1(int log2_n, const AtN1& at_n1, std::integer_sequence<int, I...>) {
  int err = cudaErrorInvalidValue;
  (void)((log2_n == kLo + I
              ? (err = at_n1(std::integral_constant<int, 1 << ((kLo + I) / 2)>{}), true)
              : false) ||
         ...);
  return err;
}

// launch(N1, P1, P2 as integral_constants) for a 2^log2_n-point DFT, log2_n
// in kLo..kHi (n1 = 2^(log2_n / 2): 32 for 11, 64 for 12 and 13, 128 for 14
// and 15, 256 for 16 and 17) at inner / outer passes (1, 3, 4, 6): 16
// instances of each kernel an n1; cudaErrorInvalidValue outside kLo..kHi.
template <int kLo, int kHi, typename Launch>
int with_tier(int log2_n, int inner_passes, int outer_passes, const Launch& launch) {
  const auto at_n1 = [&](auto n1_constant) {
    return with_passes(inner_passes, [&](auto p1_constant) {
      return with_passes(outer_passes, [&](auto p2_constant) {
        return launch(n1_constant, p1_constant, p2_constant);
      });
    });
  };
  return with_tier_n1<kLo>(log2_n, at_n1, std::make_integer_sequence<int, kHi - kLo + 1>{});
}

// K6t over log2_m in kLo..kHi (sed_tier_packed_fft), on the current device.
template <int kLo, int kHi>
int launch_packed_fft(const void* wave, const void* window, const void* tab1, const void* tab2,
                      const void* twiddle, void* out_re, void* out_im, long long rows,
                      long long n_samples, int n_frames, int hop, int log2_m, int inner_passes,
                      int outer_passes, void* stream) {
  int device = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const TierSource src{wave, static_cast<const float*>(window), n_samples, n_frames, hop, 0};
  const auto* t1 = static_cast<const __nv_bfloat16*>(tab1);
  const auto* t2 = static_cast<const __nv_bfloat16*>(tab2);
  const auto* tw = static_cast<const float2*>(twiddle);
  auto* re = static_cast<float*>(out_re);
  auto* im = static_cast<float*>(out_im);
  const auto s = static_cast<cudaStream_t>(stream);
  return with_tier<kLo, kHi>(log2_m, inner_passes, outer_passes, [&](auto n1, auto p1, auto p2) {
    constexpr int N1 = decltype(n1)::value, P1 = decltype(p1)::value, P2 = decltype(p2)::value;
    constexpr PackedShape shape = packed_shape(N1, P1, P2);
    static_assert(shape.kb > 0 && shape.smem <= 232448, "tier_packed_fft_kernel: shared memory");
    const auto kernel = tier_packed_fft_kernel<N1, P1, P2>;
    const int n2 = (1 << log2_m) / N1;
    const long long units = rows * (n2 / shape.kb);
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shape.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    int per_sm = 0;
    constexpr int threads = packed_threads(shape.n1p);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, shape.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const long long ctas = units < 1LL * per_sm * n_sm ? units : 1LL * per_sm * n_sm;
    kernel<<<static_cast<unsigned>(ctas), threads, shape.smem, s>>>(src, t1, t2, tw, re, im, n2,
                                                                   units);
    return static_cast<int>(cudaGetLastError());
  });
}

#ifndef SED_FEATURIZER_ONE_TIER_UNIT
// ---------------------------------------------------------------------------
// The Stockham FFT above n_fft 131072 (K1, K3, K6; K5 runs K1's launches then
// K2): m = n_fft / 2 = R * 2^16 points, R = 2, 4, 8 at n_fft 2^18, 2^19,
// 2^20.  A cluster of 4 CTAs holds 2^16 points (cluster_fft) and no cluster
// holds such a frame, so cluster_fft's decimation in frequency runs once
// more, through device memory:
//   fft_cross_pass_kernel<R> reads each frame with K1's or K3's loader values
//     (TierFrame: K1's framing and reflected edges, K3's f32 or int16 rows;
//     windowed as PackedWaveLoad and PackedRowLoad window them), forms the
//     exact radix-R butterflies over its R chunks of M = 2^16 points (rotate,
//     as CrossLoad's: R = 8 as radix 4, then radix 2, since a radix-8
//     butterfly would multiply by sqrt(2)/2), twiddles each output by W_m^(n1
//     r) after each level (float64 on the host, rounded once to f32) and
//     writes R sub-rows of M complex points, so that Z[s + R k] =
//     FFT_M(sub-row s)[k];
//   fft_subrows_kernel runs cluster_fft on each sub-row (the n_fft 131072
//     FFT: its twiddle table, its cross pass over distributed shared memory)
//     and writes its Z in place, each CTA's bins r + 4 k1 at k1 of its own
//     quarter of the row (K1, K3: coalesced stores), or to K6's rows at bin
//     s + R k (natural order, strided by R);
//   packed_power_kernel forms K1's and K3's one-sided power from the sub-rows'
//     Z by PowerStore's arithmetic, in natural bin order.
// K1 and K3 are three launches, K6 two; the scratch is 8 bytes a point (12.2
// GB at 2^20 for 2912 frames), from the wrapper's caching allocator.
// tests/test_torch_fft_plan.py models the three (global_cross_pass,
// subrow_bins, inplace_store, packed_power).
// ---------------------------------------------------------------------------

constexpr int kSubLog2M = 16;    // a sub-row's points (a cluster of 4 CTAs)
constexpr int kPassThreads = 256;

// One thread a (frame, n1), n1 < M: points n1 + M q of the frame (q < R) to
// sub-rows s of out (frame f at out + f m).  cross: W_m^(n1 r), R rows of M
// (R = 2, 4); at R = 8, 4 rows of 2M of W_m^(n1' r1), then M of W_2M^n1.
template <int R>
__global__ void __launch_bounds__(kPassThreads)
fft_cross_pass_kernel(const TierSource src, const float2* __restrict__ cross,
                      float2* __restrict__ out) {
  constexpr int M = 1 << kSubLog2M;
  constexpr int m = R * M;
  const long long i = static_cast<long long>(blockIdx.x) * kPassThreads + threadIdx.x;
  const long long f = i >> kSubLog2M;
  const int n1 = static_cast<int>(i & (M - 1));
  const TierFrame frame(src, f, 2 * m);
  const auto* window = reinterpret_cast<const float2*>(src.window);
  float2 z[R];
#pragma unroll
  for (int q = 0; q < R; ++q) z[q] = packed_point(frame, window, n1 + M * q);
  float2* row = out + f * m + n1;
  if constexpr (R <= 4) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float2 acc = z[0];
#pragma unroll
      for (int q = 1; q < R; ++q) acc = acc + rotate<R>(z[q], q * r);
      row[r * M] = r == 0 ? acc : cmul(acc, __ldg(cross + r * M + n1));
    }
  } else {
    // Radix 4 over chunks of 2M (n1' = n1 + M j: points n1 + M (j + 2 q1)),
    // then radix 2 over each output: sub-row s = r1 + 4 r2.
    constexpr int M2 = 2 * M;
    float2 y[4][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int r1 = 0; r1 < 4; ++r1) {
        float2 acc = z[j];
#pragma unroll
        for (int q1 = 1; q1 < 4; ++q1) acc = acc + rotate<4>(z[j + 2 * q1], q1 * r1);
        y[r1][j] = r1 == 0 ? acc : cmul(acc, __ldg(cross + r1 * M2 + n1 + M * j));
      }
    }
#pragma unroll
    for (int r1 = 0; r1 < 4; ++r1) {
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        const float2 u = y[r1][0] + rotate<2>(y[r1][1], r2);
        row[(r1 + 4 * r2) * M] = r2 == 0 ? u : cmul(u, __ldg(cross + 4 * M2 + n1));
      }
    }
  }
}

// A CTA's 2^14 points of a sub-row of complex points, stockham_fft's loader.
struct ComplexRowLoad {
  const float2* x;
  template <int T, int P>
  __device__ __forceinline__ void fill(float2 (&v)[kPoints], int t) const {
#pragma unroll
    for (int s = 0; s < P; ++s) v[s] = x[t + T * s];
  }
};

// ClusterSplitStore with strides: bin r + C k1 of the sub-row (CTA r, k1 =
// t + T s) to re[r * cta + k1 * step] and im[the same].
template <int C>
struct ClusterStridedStore {
  float* re;
  float* im;
  long long cta, step;
  template <int T, int P>
  __device__ __forceinline__ void drain(const float2 (&v)[kPoints], int t) const {
    const long long base = cg::this_cluster().block_rank() * cta;
#pragma unroll
    for (int s = 0; s < P; ++s) {
      const long long k = base + (t + T * s) * step;
      re[k] = v[s].x;
      im[k] = v[s].y;
    }
  }
};

// cluster_fft of sub-row g = blockIdx.x / C of rows (2^16 complex points a
// row; frame g >> log2_r, sub-row s = g mod 2^log2_r).  Every CTA's loads end
// before CrossLoad's first cluster barrier, so the sub-row's Z can go back in
// its place (kNatural false: K1, K3), bin r + C k1 at r 2^14 + k1; kNatural,
// to out_re / out_im of the frame at bin s + R k (K6's rows).
template <bool kNatural>
__global__ void __launch_bounds__(kStockhamThreads<kSubLog2M>, 1)
fft_subrows_kernel(float2* rows, const float2* __restrict__ twiddle, float* out_re,
                   float* out_im, int log2_r) {
  extern __shared__ float exchange[];  // re: 2^14 floats, then im
  constexpr int C = kClusterCtas<kSubLog2M>;
  constexpr int M = 1 << kCtaLog2M;
  const long long g = blockIdx.x / C;
  const int r = static_cast<int>(blockIdx.x % C);
  float2* row = rows + (g << kSubLog2M);
  const CrossLoad<C, ComplexRowLoad> load{{row + r * M}, twiddle + M, exchange, exchange + M};
  const long long base =
      ((g >> log2_r) << (kSubLog2M + log2_r)) + (g & ((1LL << log2_r) - 1));
  const ClusterStridedStore<C> store =
      kNatural ? ClusterStridedStore<C>{out_re + base, out_im + base, 1LL << log2_r,
                                        static_cast<long long>(C) << log2_r}
               : ClusterStridedStore<C>{reinterpret_cast<float*>(row),
                                        reinterpret_cast<float*>(row) + 1, 2 * M, 2};
  stockham_fft<kCtaLog2M>(load, store, twiddle, exchange, exchange + M);
}

// One-sided power (m + 1 bins a frame) from the sub-rows' Z (m points a
// frame; Z[k] in sub-row s = k mod R, its bin q = k / R at (q mod 4) 2^14 +
// q / 4, fft_subrows_kernel's in-place order): bin k < m
// hermitian_power(Z[k], Z[(m - k) mod m], W_N^k), bin m (Re Z[0] - Im
// Z[0])^2, as PowerStore.  One thread a bin, blocks_per_row blocks a frame.
__global__ void __launch_bounds__(kPassThreads)
packed_power_kernel(const float2* __restrict__ z, const float2* __restrict__ unpack,
                    float* __restrict__ out, int log2_m, int log2_r, int blocks_per_row) {
  const long long f = blockIdx.x / blocks_per_row;
  const int k = static_cast<int>(blockIdx.x - f * blocks_per_row) * kPassThreads + threadIdx.x;
  const int m = 1 << log2_m;
  if (k > m) return;
  const float2* zf = z + (f << log2_m);
  const auto at = [&](int j) {
    const int q = j >> log2_r;
    return __ldg(zf + ((j & ((1 << log2_r) - 1)) << kSubLog2M) + ((q & 3) << kCtaLog2M) +
                 (q >> 2));
  };
  float* row = out + f * (m + 1LL);
  if (k == m) {
    const float2 z0 = at(0);
    const float x = z0.x - z0.y;
    row[m] = x * x;
  } else {
    row[k] = hermitian_power(at(k), at((m - k) & (m - 1)), __ldg(unpack + k));
  }
}
#endif  // SED_FEATURIZER_ONE_TIER_UNIT

#if !defined(SED_FEATURIZER_NO_TIERS) && \
    (!defined(SED_FEATURIZER_ONE_TIER_UNIT) || defined(SED_FEATURIZER_GEMM_TIERS_ONLY) || \
     defined(SED_FEATURIZER_TIERS_ONLY))
// ---------------------------------------------------------------------------
// The tier DFT where tier_fused_kernel's and tier_packed_fft_kernel's
// instances do not reach: K1t and K3t at n_fft 128..1024, 65536..2^20 and
// where fused_route declines, K6t at 256..2048 and 2^18..2^20 (K5t runs
// K1t's launches, then K2).  The split pass also feeds tier_fused_kernel
// (further down).  sed_tpu's two stages (n = n1 n2, n1 = 2^(log2 n / 2): n1
// 8..1024, n2 16..1024) as two GEMMs on wgmma through device memory, over a
// group of frames at a time
// (gemm_plan: the group's planes stay under kGemmScratch bytes):
//   tier_split_kernel<C1, kPacked>, the split pass: each frame of the group
//     framed and windowed as K1 and K3 read it (TierFrame; K6t's packed
//     points), split once into stage 1's C1 bf16 chunks (split_bf16's
//     rounding), written as X planes: row f n1 + b, k = a (X[a][b] =
//     x[a n1 + b]; K6t: k = a over Re z, n2 + a over Im z of point a n1 + b);
//   tier_inner_kernel<P1, C2>, stage 1: [rows 16t + 8h + i: part h of Y at k2 =
//     8t + i] = tab1 @ X over the tier's terms, then the f32 twiddle
//     (sed_tpu's order) and the split into stage 2's C2 chunks in the epilogue,
//     written as T planes: row f n2 + k2, k = b (Tr) and n1 + b (Ti);
//   tier_outer_kernel<P2, kPacked>, stage 2: columns 2 k1 + h (Zr, Zi) of
//     T @ tab2, then |Z|^2 to bin n2 k1 + k2 (K1t, K3t: k1 < n1/2, and bin
//     n/2 at k2 = 0) or Zr, Zi to K6's rows at bin n2 k1 + k2 (K6t: every k1).
// Replaces, at those sizes, what the tier instances replace:
// _make_wave_fft_power_kernel_roll (:412), _make_fft_power_kernel (:283)
// and _make_wave_packed_fft_kernel (:882) through _stage_dots (:272) /
// _make_dot (:191); K5t's _make_wave_fft_mel_kernel_roll (:550) as these,
// then K2.  Bound on an H100 SXM: operations at fast above n_fft 131072
// (K1t at 2^18, 16 x 60 s: 9.4 TFLOP, 9.50 ms at 989 TFLOP/s dense bf16,
// against ~12 GB of planes, 3.7 ms at 3.35 TB/s); bytes at the small end.
// No main loop splits anything.  Every operand is a plane of C chunks in the
// shared-memory image wgmma reads (plane_byte: K tiles of 64 k, rows of 128
// bytes under the 128-byte swizzle), so one bulk copy (cp.async.bulk) brings
// a chunk of a tile: the tables (cuda_featurizer._gemm_images, made once on
// the host), the X planes (the split pass) and the T planes (stage 1).
// Both stages are one persistent kernel (gemm_mainloop) of three
// warpgroups: one thread of warpgroup 0 keeps the copies of A and B tiles
// (kGemmBM rows of A, gemm_bn(C) rows of B, every chunk, 64 k) in flight in
// a ring of gemm_stages(C) slots on mbarriers; warpgroups 1 and 2 each take
// 64 rows of the CTA tile and issue wgmma.m64nNk16 over the tier's
// (chunk, chunk) terms (tier_term).  CTAs walk the tiles, so one tile's
// epilogue (its direct stores) overlaps the next tile's copies; stage 1
// walks a column tile's row tiles next to each other (the X tile comes
// from L2 after the first), stage 2 a row tile's column tiles (the T tile).
// Each 64-deep k tile's products go to an accumulator of their own, added
// to the tile's sum in f32: the tensor cores' accumulation is not round-to-
// nearest, and over the 1024 and 2048 k of n_fft 2^20 its error in one
// running sum passes the plain version's tolerance at bf16x6 (tier_rel_tol;
// tests/test_torch_packed_tiers.py models the depths).  Rows of an operand
// past its data (stage 1's 2 n2 = 32 or 64 of a 128-row tile, a group's last
// row tile) are skipped by the warpgroup that holds them or by the epilogue;
// k past the operand's (n2 or 2 n1 = 16, 32) is never multiplied.  The
// same data flow is modelled in numpy by tests/test_torch_packed_tiers.py.
// ---------------------------------------------------------------------------

constexpr int kGemmThreads = 384;  // warpgroup 0 copies, warpgroups 1 and 2 multiply
constexpr int kGemmBM = 128;       // rows of A a CTA tile: 64 a multiplying warpgroup
constexpr int kGemmK = 64;         // k of a tile: a row of 128 bytes
constexpr long long kGemmScratch = 1LL << 31;  // a frame group's X and T planes, bytes
constexpr int kSplitThreads = 256;

// B rows a CTA tile (128, or 64 at three chunks, bf16x6, whose 128-row slot
// would not fit three in 227 KB), the ring's slots and bytes, the dynamic
// shared memory (the ring, its barriers, 1024 bytes of alignment).
__host__ __device__ constexpr int gemm_bn(int c) { return c == 3 ? 64 : 128; }
__host__ __device__ constexpr int gemm_slot(int c) { return c * (kGemmBM + gemm_bn(c)) * 128; }
__host__ __device__ constexpr int gemm_stages(int c) { return c == 1 ? 6 : 3; }
__host__ __device__ constexpr int gemm_smem(int c) {
  return gemm_stages(c) * (gemm_slot(c) + 16) + 1024;
}
__host__ __device__ constexpr long long round_up(long long x, long long m) {
  return (x + m - 1) / m * m;
}

// Byte of element (chunk c, row r, k) of a plane of `rows` rows and kt k
// tiles a chunk: tile-major, so the rows of one (chunk, k tile) are one run.
__host__ __device__ __forceinline__ long long plane_byte(int c, long long r, int k, int kt,
                                                         long long rows) {
  return ((static_cast<long long>(c) * kt + (k >> 6)) * rows + r) * 128 +
         ((((k & 63) >> 3) ^ static_cast<int>(r & 7)) << 4) + (k & 7) * 2;
}

// The layout of a group's planes and tables at (n1, n2), packed or not, C1
// and C2 chunks, g frames: k tiles, padded rows, bytes.
struct GemmShape {
  int log2_n1, log2_n2, packed, c1, c2;
  long long g;
  __host__ __device__ int n1() const { return 1 << log2_n1; }
  __host__ __device__ int n2() const { return 1 << log2_n2; }
  __host__ __device__ int k1() const { return n2() << packed; }  // stage 1's k
  __host__ __device__ int k2() const { return 2 * n1(); }        // stage 2's k
  __host__ __device__ int kt1() const { return (k1() + kGemmK - 1) / kGemmK; }
  __host__ __device__ int kt2() const { return (k2() + kGemmK - 1) / kGemmK; }
  __host__ __device__ int cols2() const { return packed ? 2 * n1() : n1() + 8; }
  __host__ __device__ long long tab1_rows() const { return round_up(2 * n2(), kGemmBM); }
  __host__ __device__ long long tab2_rows() const { return round_up(cols2(), gemm_bn(c2)); }
  __host__ __device__ long long x_rows() const { return round_up(g << log2_n1, gemm_bn(c1)); }
  __host__ __device__ long long t_rows() const { return round_up(g << log2_n2, kGemmBM); }
  __host__ __device__ long long x_bytes() const { return c1 * kt1() * x_rows() * 128; }
  __host__ __device__ long long t_bytes() const { return c2 * kt2() * t_rows() * 128; }
};

// Frames a group: all of them where their planes fit kGemmScratch, else as
// many as fit (at least one).
inline long long gemm_group(GemmShape s, long long frames) {
  const auto bytes = [&s](long long g) {
    s.g = g;
    return s.x_bytes() + s.t_bytes();
  };
  if (bytes(frames) <= kGemmScratch) return frames;
  const long long per_frame =
      128LL * (s.c1 * s.kt1() * s.n1() + s.c2 * s.kt2() * s.n2());  // unpadded
  long long g = kGemmScratch / per_frame;
  while (g > 1 && bytes(g) > kGemmScratch) --g;
  return g < 1 ? 1 : g;
}

// mbar_wait with a watchdog: a wait of more than 10 s traps, so that a fault
// of the ring's protocol ends the launch with an error instead of hanging.
__device__ __forceinline__ void gemm_wait(unsigned long long* bar, unsigned parity) {
  unsigned long long t0 = 0;
  for (unsigned spin = 0;; ++spin) {
    unsigned done = 0;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_address(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if ((spin & 1023) == 0) {
      unsigned long long now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (t0 == 0) t0 = now;
      else if (now - t0 > 10000000000ull) __trap();
    }
  }
}

// The split pass: a block takes 64 rows r0 .. (r = f n1 + b) of the X
// planes and 64 of their k (real input: k tile kt; packed: the points' a0 ..
// a0 + 63, written as Re z at k = a and Im z at n2 + a).  Its threads load
// the frames' samples along b (K1's and K3's loads and window, TierFrame),
// hold them in shared memory as [k][r], then write each row's 8 k a thread
// as C 16-byte chunk stores, four whole 128-byte rows a warp.
template <int C, bool kPacked>
__global__ void __launch_bounds__(kSplitThreads)
tier_split_kernel(const TierSource src, unsigned char* __restrict__ x, long long row0,
                  GemmShape s) {
  constexpr int kParts = kPacked ? 2 : 1;  // packed: Re z, Im z
  __shared__ float vals[kParts][64][65];
  const int n1 = s.n1(), n2 = s.n2();
  const int k_tiles = kPacked ? (n2 + 63) / 64 : s.kt1();
  const long long r0 = static_cast<long long>(blockIdx.x / k_tiles) * 64;
  const int a0 = static_cast<int>(blockIdx.x % k_tiles) * 64;  // k (packed: a) of the block
  const int count = min(64, (kPacked ? n2 : s.k1()) - a0);
  const long long rows = s.g << s.log2_n1;
  const auto* window = reinterpret_cast<const float2*>(src.window);
  const int t = threadIdx.x;
  if constexpr (kPacked) {  // row r0 + t % 64, points a = a0 + t / 64 + 4i
    const long long r = r0 + t % 64;
    const TierFrame frame(src, row0 + (r < rows ? r >> s.log2_n1 : 0), 2 * n1 * n2);
    const int b = static_cast<int>(r & (n1 - 1));
#pragma unroll 4
    for (int i = 0; i < 16; ++i) {
      const int a = t / 64 + 4 * i;
      float2 z = make_float2(0.f, 0.f);
      if (a < count && r < rows) z = packed_point(frame, window, (a0 + a) * n1 + b);
      vals[0][a][t % 64] = z.x;
      vals[1][a][t % 64] = z.y;
    }
  } else {  // rows r0 + 2 (t % 32) and the next, k = a0 + t / 32 + 8i
    const long long r = r0 + 2 * (t % 32);
    const TierFrame frame(src, row0 + (r < rows ? r >> s.log2_n1 : 0), n1 * n2);
    const int b = static_cast<int>(r & (n1 - 1));
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = t / 32 + 8 * i;
      float2 v = make_float2(0.f, 0.f);
      if (k < count && r < rows) {
        const int smp = (a0 + k) * n1 + b;  // samples smp, smp + 1
        v = windowed(frame.raw(smp), __ldg(window + (smp >> 1)));
      }
      vals[0][k][2 * (t % 32)] = v.x;
      vals[0][k][2 * (t % 32) + 1] = v.y;
    }
  }
  __syncthreads();
  const int kt = s.kt1();
  const long long x_rows = s.x_rows();
#pragma unroll
  for (int part = 0; part < kParts; ++part) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int item = t + kSplitThreads * j;  // (row, octet): 8 octets a row
      const int o = item % 8, rl = item / 8;
      if (8 * o >= count || r0 + rl >= rows) continue;
      float w[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) w[e] = vals[part][8 * o + e][rl];
      const int k = a0 + 8 * o + part * n2;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        uint4 out;
        unsigned* op = reinterpret_cast<unsigned*>(&out);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 pair = __floats2bfloat162_rn(w[2 * e], w[2 * e + 1]);
          op[e] = *reinterpret_cast<const unsigned*>(&pair);
          if (c + 1 < C) {
            const float2 back = __bfloat1622float2(pair);
            w[2 * e] -= back.x;
            w[2 * e + 1] -= back.y;
          }
        }
        *reinterpret_cast<uint4*>(x + plane_byte(c, r0 + rl, k, kt, x_rows)) = out;
      }
    }
  }
}

// The two stages' operands and tiles: A planes of a_rows rows (the CTA
// tile's kGemmBM of them, m_valid holding data), B planes of b_rows rows
// (BN a tile), k (a multiple of 16) in kt tiles; tile t is (mt, nt) with mt
// = t % m_tiles (a_fast: stage 1) or nt = t % n_tiles (stage 2).
struct GemmOperands {
  const unsigned char* a;
  const unsigned char* b;
  long long a_rows, b_rows, m_valid, m_tiles, n_tiles;
  int k, kt;
  bool a_fast;
};

// The persistent CTA's loop over its tiles (see the note above);
// epilogue(acc, mt, nt, row) is called by each multiplying thread with its
// m64nBN fragment (acc[4i + 2h + e]: row + 8h, column nt BN + 8i + 2 (lane
// mod 4) + e, row = mt kGemmBM + 64 w + 16 warp + lane / 4 of its warpgroup
// w), whose rows all lie past m_valid where it is not called.
template <int P, typename Epilogue>
__device__ __forceinline__ void gemm_mainloop(const GemmOperands& op, const Epilogue& epilogue) {
  constexpr int C = tier_chunks(P), BN = gemm_bn(C), S = gemm_stages(C);
  constexpr int A_CHUNK = kGemmBM * 128, B_CHUNK = BN * 128, SLOT = gemm_slot(C);
  extern __shared__ __align__(16) unsigned char gemm_smem_raw[];
  unsigned char* ring =
      gemm_smem_raw + ((1024 - (smem_address(gemm_smem_raw) & 1023)) & 1023);
  auto* full = reinterpret_cast<unsigned long long*>(ring + S * SLOT);
  auto* empty = full + S;
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + i, 1);   // the producer's arrive, the copies' bytes by expect_tx
      mbar_init(empty + i, 8);  // each multiplying warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const long long tiles = op.m_tiles * op.n_tiles;
  const auto tile_at = [&](long long t, long long& mt, long long& nt) {
    if (op.a_fast) {
      mt = t % op.m_tiles;
      nt = t / op.m_tiles;
    } else {
      nt = t % op.n_tiles;
      mt = t / op.n_tiles;
    }
  };

  if (threadIdx.x < 128) {  // ---- the producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x != 0) return;
    long long seq = 0;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      long long mt, nt;
      tile_at(t, mt, nt);
      for (int kt = 0; kt < op.kt; ++kt, ++seq) {
        const int slot = static_cast<int>(seq % S);
        if (seq >= S) gemm_wait(empty + slot, static_cast<unsigned>((seq / S - 1) & 1));
        unsigned char* dst = ring + slot * SLOT;
        mbar_arrive_expect_tx(full + slot, SLOT);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          bulk_copy(reinterpret_cast<float*>(dst + c * A_CHUNK),
                    reinterpret_cast<const float*>(
                        op.a + ((static_cast<long long>(c) * op.kt + kt) * op.a_rows +
                                mt * kGemmBM) * 128),
                    A_CHUNK, full + slot);
          bulk_copy(reinterpret_cast<float*>(dst + C * A_CHUNK + c * B_CHUNK),
                    reinterpret_cast<const float*>(
                        op.b + ((static_cast<long long>(c) * op.kt + kt) * op.b_rows + nt * BN) *
                                   128),
                    B_CHUNK, full + slot);
        }
      }
    }
    return;
  }

  // ---- the multiplying warpgroups ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int w = threadIdx.x / 128 - 1, lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const unsigned ring_addr = smem_address(ring);
  long long seq = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    long long mt, nt;
    tile_at(t, mt, nt);
    const bool active = mt * kGemmBM + 64 * w < op.m_valid;
    float acc[BN / 2], part[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < op.kt; ++kt, ++seq) {
      const int slot = static_cast<int>(seq % S);
      gemm_wait(full + slot, static_cast<unsigned>((seq / S) & 1));
      if (active) {
        const unsigned a = ring_addr + slot * SLOT + w * 64 * 128, b = ring_addr + slot * SLOT +
                                                                       C * A_CHUNK;
        const int steps = min(4, (op.k - kt * kGemmK) >> 4);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) part[i] = 0.f;
        fence_operands(part);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j >= steps) break;
#pragma unroll
          for (int ca = 0; ca < C; ++ca)
#pragma unroll
            for (int cb = 0; cb < C; ++cb) {
              if (!tier_term(P, ca, cb)) continue;
              Wgmma<BN>::mma(part, sw128_desc(a + ca * A_CHUNK, j),
                             sw128_desc(b + cb * B_CHUNK, j));
            }
        }
        wgmma_commit();
        fence_operands(part);
        wgmma_wait<0>();
        fence_operands(part);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);
      if (active) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
      }
    }
    if (active) epilogue(acc, mt, nt, mt * kGemmBM + 64 * w + 16 * warp + (lane >> 2));
  }
}

// a[j] of lane q of each quad <- a[q] of its lane j (a 4 x 4 transpose of
// the quad's words by two exchanges).
__device__ __forceinline__ void quad_transpose(unsigned (&a)[4], int q) {
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j & m) continue;  // the pair (j, j + m)
      const unsigned recv = __shfl_xor_sync(0xffffffffu, (q & m) ? a[j] : a[j | m], m);
      if (q & m)
        a[j] = recv;
      else
        a[j | m] = recv;
    }
  }
}

// Stage 1 over a group of s.g frames: X planes (the split pass's) by tab1
// (C1 chunks of tab1_rows x k1), then the twiddle, split into C2 chunks, to
// the T planes.  Where a tile's columns are one frame's (n1 >= BN: every
// size above 131072), each quad of lanes transposes the words of four
// column pairs, so that a lane stores 16 bytes (8 b of a T row) and a warp
// two whole 32-byte sectors of each of its 8 rows a store.
template <int P1, int C2>
__global__ void __launch_bounds__(kGemmThreads, 1)
tier_inner_kernel(const unsigned char* __restrict__ x, const unsigned char* __restrict__ tab1,
                  const float2* __restrict__ twiddle, unsigned char* __restrict__ t_out,
                  GemmShape s) {
  constexpr int BN = gemm_bn(tier_chunks(P1));
  const GemmOperands op{tab1, x, s.tab1_rows(), s.x_rows(), 2LL * s.n2(),
                        s.tab1_rows() / kGemmBM, s.x_rows() / BN, s.k1(), s.kt1(), true};
  const int n1 = s.n1(), n2 = s.n2(), kt2 = s.kt2();
  const long long cols = s.g << s.log2_n1, t_rows = s.t_rows();
  const int tig = threadIdx.x & 3;
  gemm_mainloop<P1>(op, [&](const float (&acc)[BN / 2], long long, long long nt, long long row) {
    // acc[4i ..]: yr(b), yr(b + 1), yi(b), yi(b + 1) at k2 = row / 2 (rows
    // 16t + g and 16t + 8 + g: Yr and Yi at k2 = 8t + g), b = the column's.
    const int k2 = static_cast<int>((row >> 4) * 8 + (row & 7));
    if (k2 >= n2) return;
    // T of column pair i (b, b + 1), split: (Tr, Ti) words of each chunk.
    const auto t_words = [&](int i, int b, unsigned (&cr)[C2], unsigned (&ci)[C2]) {
      const float4 tw = *reinterpret_cast<const float4*>(twiddle + (k2 << s.log2_n1) + b);
      const float* y = acc + 4 * i;
      const float tr0 = __fsub_rn(__fmul_rn(y[0], tw.x), __fmul_rn(y[2], tw.y));
      const float ti0 = __fadd_rn(__fmul_rn(y[0], tw.y), __fmul_rn(y[2], tw.x));
      const float tr1 = __fsub_rn(__fmul_rn(y[1], tw.z), __fmul_rn(y[3], tw.w));
      const float ti1 = __fadd_rn(__fmul_rn(y[1], tw.w), __fmul_rn(y[3], tw.z));
      split_bf16x2<C2>(tr0, tr1, cr);
      split_bf16x2<C2>(ti0, ti1, ci);
    };
    if (n1 >= BN) {  // the tile's columns: b0 .. b0 + BN - 1 of frame f
      const long long col0 = nt * BN;
      const long long rt = ((col0 >> s.log2_n1) << s.log2_n2) + k2;
      const int b0 = static_cast<int>(col0 & (n1 - 1)), sw = static_cast<int>(rt & 7);
      unsigned char* t_row = t_out + rt * 128;
#pragma unroll
      for (int ig = 0; ig < BN / 32; ++ig) {
        unsigned w[2][C2][4];  // Tr and Ti, chunk, column pair 4 ig + j
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          unsigned cr[C2], ci[C2];
          t_words(4 * ig + j, b0 + 8 * (4 * ig + j) + 2 * tig, cr, ci);
#pragma unroll
          for (int c = 0; c < C2; ++c) {
            w[0][c][j] = cr[c];
            w[1][c][j] = ci[c];
          }
        }
#pragma unroll
        for (int part = 0; part < 2; ++part)
#pragma unroll
          for (int c = 0; c < C2; ++c) {
            quad_transpose(w[part][c], tig);  // this lane: pair 4 ig + tig, b 8 of them
            const int k = part * n1 + b0 + 8 * (4 * ig + tig);
            *reinterpret_cast<uint4*>(t_row + (static_cast<long long>(c) * kt2 + (k >> 6)) *
                                                  t_rows * 128 + ((((k & 63) >> 3) ^ sw) << 4)) =
                make_uint4(w[part][c][0], w[part][c][1], w[part][c][2], w[part][c][3]);
          }
      }
      return;
    }
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {  // the small end: columns of several frames
      const long long col = nt * BN + 8 * i + 2 * tig;
      if (col >= cols) continue;
      const int b = static_cast<int>(col & (n1 - 1));
      const long long rt = ((col >> s.log2_n1) << s.log2_n2) + k2;
      unsigned cr[C2], ci[C2];
      t_words(i, b, cr, ci);
#pragma unroll
      for (int c = 0; c < C2; ++c) {
        *reinterpret_cast<unsigned*>(t_out + plane_byte(c, rt, b, kt2, t_rows)) = cr[c];
        *reinterpret_cast<unsigned*>(t_out + plane_byte(c, rt, n1 + b, kt2, t_rows)) = ci[c];
      }
    }
  });
}

// Stage 2 over a group of s.g frames: the T planes by tab2 (C2 chunks of
// tab2_rows x 2 n1), to |Z|^2 in out (rows of n/2 + 1) or, kPacked, Zr and
// Zi in out and out_im (rows of n).
template <int P2, bool kPacked>
__global__ void __launch_bounds__(kGemmThreads, 1)
tier_outer_kernel(const unsigned char* __restrict__ t_in, const unsigned char* __restrict__ tab2,
                  float* __restrict__ out, float* __restrict__ out_im, GemmShape s) {
  constexpr int BN = gemm_bn(tier_chunks(P2));
  const long long rows = s.g << s.log2_n2;
  const GemmOperands op{t_in, tab2, s.t_rows(), s.tab2_rows(), rows, s.t_rows() / kGemmBM,
                        s.tab2_rows() / BN, s.k2(), s.kt2(), false};
  const int n1 = s.n1(), n2 = s.n2();
  const long long n = static_cast<long long>(n1) << s.log2_n2;
  const int tig = threadIdx.x & 3;
  gemm_mainloop<P2>(op, [&](const float (&acc)[BN / 2], long long, long long nt, long long row0) {
    // acc[4i + 2h], [4i + 2h + 1]: Zr, Zi of k1 = the column pair's at row0 + 8h.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = row0 + 8 * h;
      if (row >= rows) continue;
      const long long f = row >> s.log2_n2;
      const int k2 = static_cast<int>(row & (n2 - 1));
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int k1 = static_cast<int>((nt * BN + 8 * i) / 2) + tig;
        const float zr = acc[4 * i + 2 * h], zi = acc[4 * i + 2 * h + 1];
        if constexpr (kPacked) {
          if (k1 < n1) {
            const long long q = f * n + (static_cast<long long>(k1) << s.log2_n2) + k2;
            out[q] = zr;
            out_im[q] = zi;
          }
        } else {
          float* o = out + f * (n / 2 + 1);
          if (k1 < n1 / 2)
            o[(static_cast<long long>(k1) << s.log2_n2) + k2] = tier_power(zr, zi);
          else if (k1 == n1 / 2 && k2 == 0)
            o[n / 2] = tier_power(zr, zi);
        }
      }
    }
  });
}

// kernel<<<grid, kGemmThreads, smem>>> with the grid the tiles' count, at
// most a CTA an SM.
template <typename... Params, typename... Args>
int launch_gemm(void (*kernel)(Params...), int smem, long long tiles, int device,
                cudaStream_t stream, const Args&... args) {
  int n_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long grid = tiles < n_sm ? tiles : n_sm;
  if (grid < 1) return cudaErrorInvalidValue;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(grid));
  config.blockDim = dim3(kGemmThreads);
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = stream;
  err = cudaLaunchKernelEx(&config, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The shape of a group of `frames` frames, or an error for a size or pass
// count the GEMMs do not take.
cudaError_t gemm_shape(int log2_n1, int log2_n2, int packed, int inner, int outer,
                       long long frames, GemmShape* s) {
  const bool passes_ok = (inner == 1 || inner == 3 || inner == 4 || inner == 6) &&
                         (outer == 1 || outer == 3 || outer == 4 || outer == 6);
  if (!passes_ok || log2_n1 < 3 || log2_n2 < 4 || log2_n1 > 10 || log2_n2 > 10 ||
      log2_n1 > log2_n2 || frames < 1 || (packed != 0 && packed != 1))
    return cudaErrorInvalidValue;
  *s = GemmShape{log2_n1, log2_n2, packed, tier_chunks(inner), tier_chunks(outer), frames};
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// K1t and K3t (tier_fused_kernel<P1, P2, N1>) at the sizes and pass counts
// where fused_route takes them: n_fft 2048..32768 (n1 32..128, n2 64..256).
// K5t is K1t's route, then K2.
// The split pass (tier_split_kernel above) writes each frame's C1 bf16
// chunks once, as a group's X planes; then one persistent kernel takes both
// stages of a unit, (frame, 64 k2 rows), with T in shared memory only.  It
// reads the tier GEMMs' tables and planes (cuda_featurizer._gemm_images,
// plane_byte), so each chunk of a tile is one bulk copy:
//   * the first thread of warp 8 (after the two multiplying warpgroups)
//     keeps copies in flight in a ring of D slots on mbarriers, in the
//     consumers' order: for each of the unit's stage-1
//     passes (np columns b of n1) and each 64-deep k tile, the unit's 128
//     rows of the tab1 plane (Yr, Yi of its 64 k2 rows, interleaved by 8)
//     and the pass's np rows of the frame's X plane; then, for each of stage
//     2's 2 n1 / 64 k tiles, the n1 + 8 rows of the tab2 plane (columns 2 k1
//     + h: the one-sided k1 < n1 / 2, then bin n / 2's at k1 = n1 / 2);
//   * warpgroups 0 and 1 each multiply 64 of the 128 rows (32 k2 rows) by
//     wgmma.m64n(np)k16 over the tier's terms, a k tile's products into an
//     accumulator of their own, added to the pass's sum in f32 (as the
//     GEMMs); the epilogue twiddles in f32 (sed_tpu's order, no fused
//     multiply-add), splits T into C2 chunks (split_bf16) and stores them in
//     the K-major swizzled image that stage 2's wgmma reads as A (64 rows k2,
//     K = [Tr | Ti] over b: C2 x 2 n1 / 64 tiles of 8 KB); a proxy fence and
//     a named barrier of the two warpgroups make T whole;
//   * stage 2: each warpgroup multiplies T by its half of the tab2 tile's
//     columns (wgmma.m64n(n1/2)k16; warpgroup 1 also bin n / 2's 8 columns,
//     m64n8k16, in a frame's first unit), one running f32 sum over the 2 n1
//     <= 256 k (the mma.sync kernel it replaced summed 512 so); then |Z|^2
//     (tier_power) to bin n2 k1 + k2, 8 contiguous bins a quad of lanes.
// CTAs walk the units u = blockIdx.x, + gridDim.x, ..., a frame's n2 / 64
// units next to each other (its X tiles come from L2 after the first); the
// producer runs up to D tiles ahead, so the next unit's first tiles land
// while this unit's stage 2 and drain run.  T is free for the next unit once
// both warpgroups are through stage 2 (a named barrier before a unit's
// first T store).
// The shape (fused_shape: np columns a pass, D slots) is the first, by np =
// n1, 64, 32 and D = 4, 3, 2, whose T, ring and barriers fit 227 KB.  At n1
// 256 (n_fft 65536, 131072) T is 64 KB a chunk and a stage-2 slot 33 KB a
// chunk, so no shape fits but at outer bf16x1; kFusedMaxN1 keeps those sizes
// on the tier GEMMs.  fused_route also leaves to the GEMMs the shapes of
// four stage-1 passes (np 32: bf16x6 at both stages at n1 128), which
// re-read tab1 four times a unit and took 14-16% longer than the GEMMs in
// the same call; everywhere else the fused kernel was faster or level
// (PERF.md section 6; tier_gemm_sweep.py routes).  sed_tier_fused_plan
// reports the route and the shape.
// ---------------------------------------------------------------------------

constexpr int kFusedRows = 64;  // k2 rows a unit
constexpr int kFusedMaxN1 = 128;
// Two multiplying warpgroups, then one producing warp.  ptxas gives each
// thread at most 168 registers (three warps share an SM sub-partition's
// 16,384): a stage-1 pass's sum and its k tile's partial take 128 at np 128.
constexpr int kFusedThreads = 288;

// A ring slot (the larger of a stage-1 tile, tab1's 128 rows and np rows of
// X, and a stage-2 tile, tab2's n1 + 8 rows, every chunk), the dynamic
// shared memory (T, the ring, the barriers, 1024 bytes of alignment), and
// the shape: np, D, a slot's and T's bytes.
struct FusedShape {
  int np, slots, slot, t_bytes, smem;
};
__host__ __device__ constexpr int fused_slot(int n1, int c1, int c2, int np) {
  return c1 * (kGemmBM + np) * 128 > c2 * (n1 + 8) * 128 ? c1 * (kGemmBM + np) * 128
                                                         : c2 * (n1 + 8) * 128;
}
__host__ __device__ constexpr int fused_smem(int n1, int c1, int c2, int np, int slots) {
  return c2 * n1 * 256 + slots * fused_slot(n1, c1, c2, np) + 8 * 2 * slots + 1024;
}
__host__ __device__ constexpr FusedShape fused_shape(int n1, int p1, int p2) {
  const int c1 = tier_chunks(p1), c2 = tier_chunks(p2);
  if (n1 >= 32 && n1 <= kFusedMaxN1)
    for (int np = n1; np >= 32; np /= 2)
      for (int slots = 4; slots >= 2; --slots)
        if (fused_smem(n1, c1, c2, np, slots) <= 232448)
          return {np, slots, fused_slot(n1, c1, c2, np), c2 * n1 * 256,
                  fused_smem(n1, c1, c2, np, slots)};
  return {0, 0, 0, 0, 0};
}

// Whether K1t and K3t take the fused kernel at n1 and the passes (else the
// tier GEMMs): where a shape fits, in at most two stage-1 passes.
__host__ __device__ constexpr bool fused_route(int n1, int p1, int p2) {
  return fused_shape(n1, p1, p2).np * 2 >= n1;
}

// Frames a group of the fused route: all of them where their X planes fit
// kGemmScratch, else as many as fit (at least one).
inline long long fused_group(GemmShape s, long long frames) {
  s.g = frames;
  if (s.x_bytes() <= kGemmScratch) return frames;
  long long g = kGemmScratch / (128LL * s.c1 * s.kt1() * s.n1());
  for (s.g = g; g > 1 && s.x_bytes() > kGemmScratch; s.g = --g) {
  }
  return g < 1 ? 1 : g;
}

template <int P1, int P2, int N1>
__global__ void __launch_bounds__(kFusedThreads, 1)
tier_fused_kernel(const unsigned char* __restrict__ x, const unsigned char* __restrict__ tab1,
                  const unsigned char* __restrict__ tab2, const float2* __restrict__ twiddle,
                  float* __restrict__ out, GemmShape s) {
  constexpr int C1 = tier_chunks(P1), C2 = tier_chunks(P2);
  constexpr FusedShape kShape = fused_shape(N1, P1, P2);
  constexpr int NP = kShape.np, D = kShape.slots, SLOT = kShape.slot;
  constexpr int NH = N1 / NP;       // stage 1's passes
  constexpr int KT2 = 2 * N1 / 64;  // stage 2's k tiles
  constexpr int NB = N1 / 2;        // stage 2's columns a warpgroup
  constexpr int A_CHUNK = kGemmBM * 128, X_CHUNK = NP * 128, B_CHUNK = (N1 + 8) * 128;
  constexpr int T_TILE = kFusedRows * 128;
  static_assert(NP > 0 && NH * NP == N1 && KT2 >= 1, "tier_fused_kernel: shape");
  extern __shared__ __align__(16) unsigned char fused_smem_raw[];
  unsigned char* ts = fused_smem_raw + ((1024 - (smem_address(fused_smem_raw) & 1023)) & 1023);
  unsigned char* ring = ts + kShape.t_bytes;
  auto* full = reinterpret_cast<unsigned long long*>(ring + D * SLOT);
  auto* empty = full + D;
  const int n2 = s.n2(), n_blk = n2 / kFusedRows, kt1 = s.kt1();
  const long long units = s.g * n_blk, tab1_rows = s.tab1_rows(), x_rows = s.x_rows(),
                  tab2_rows = s.tab2_rows();
  if (threadIdx.x == 0) {
    for (int i = 0; i < D; ++i) {
      mbar_init(full + i, 1);   // the producer's arrive, the copies' bytes by expect_tx
      mbar_init(empty + i, 8);  // each multiplying warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // ---- the producer: warp 8's first thread ----
    if (threadIdx.x != 256) return;
    long long seq = 0;
    const auto next_slot = [&](unsigned bytes) {
      const int slot = static_cast<int>(seq % D);
      if (seq >= D) gemm_wait(empty + slot, static_cast<unsigned>((seq / D - 1) & 1));
      mbar_arrive_expect_tx(full + slot, bytes);
      ++seq;
      return slot;
    };
    for (long long u = blockIdx.x; u < units; u += gridDim.x) {
      const long long f = u / n_blk, blk = u - f * n_blk;
      for (int h = 0; h < NH; ++h)
        for (int kt = 0; kt < kt1; ++kt) {
          const int slot = next_slot(C1 * (A_CHUNK + X_CHUNK));
          unsigned char* dst = ring + slot * SLOT;
#pragma unroll
          for (int c = 0; c < C1; ++c) {
            const long long plane = static_cast<long long>(c) * kt1 + kt;
            bulk_copy(reinterpret_cast<float*>(dst + c * A_CHUNK),
                      reinterpret_cast<const float*>(tab1 +
                                                     (plane * tab1_rows + blk * kGemmBM) * 128),
                      A_CHUNK, full + slot);
            bulk_copy(reinterpret_cast<float*>(dst + C1 * A_CHUNK + c * X_CHUNK),
                      reinterpret_cast<const float*>(x + (plane * x_rows + f * N1 + h * NP) * 128),
                      X_CHUNK, full + slot);
          }
        }
      for (int kt = 0; kt < KT2; ++kt) {
        const int slot = next_slot(C2 * B_CHUNK);
        unsigned char* dst = ring + slot * SLOT;
#pragma unroll
        for (int c = 0; c < C2; ++c)
          bulk_copy(reinterpret_cast<float*>(dst + c * B_CHUNK),
                    reinterpret_cast<const float*>(
                        tab2 + (static_cast<long long>(c) * KT2 + kt) * tab2_rows * 128),
                    B_CHUNK, full + slot);
      }
    }
    return;
  }

  // ---- the multiplying warpgroups: threads 0..255 ----
  const int w = threadIdx.x / 128, lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, tig = lane & 3;
  const unsigned ring_addr = smem_address(ring), ts_addr = smem_address(ts);
  const int n_half = N1 * n2 / 2;  // bin n / 2
  long long seq = 0;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const long long f = u / n_blk;
    const int blk = static_cast<int>(u - f * n_blk), k0 = kFusedRows * blk;
    // Stage 1, a pass of NP columns b at a time, each into its T columns.
#pragma unroll 1
    for (int h = 0; h < NH; ++h) {
      float acc[NP / 2], part[NP / 2];
#pragma unroll
      for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < kt1; ++kt, ++seq) {
        const int slot = static_cast<int>(seq % D);
        gemm_wait(full + slot, static_cast<unsigned>((seq / D) & 1));
        const unsigned a = ring_addr + slot * SLOT + w * 64 * 128,
                       b = ring_addr + slot * SLOT + C1 * A_CHUNK;
#pragma unroll
        for (int i = 0; i < NP / 2; ++i) part[i] = 0.f;
        fence_operands(part);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int ca = 0; ca < C1; ++ca)
#pragma unroll
            for (int cb = 0; cb < C1; ++cb) {
              if (!tier_term(P1, ca, cb)) continue;
              Wgmma<NP>::mma(part, sw128_desc(a + ca * A_CHUNK, j),
                             sw128_desc(b + cb * X_CHUNK, j));
            }
        wgmma_commit();
        fence_operands(part);
        wgmma_wait<0>();
        fence_operands(part);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + slot);
#pragma unroll
        for (int i = 0; i < NP / 2; ++i) acc[i] += part[i];
      }
      // Both warpgroups are through the last unit's stage 2: T is free.
      if (h == 0) asm volatile("bar.sync 1, 256;" ::: "memory");
      // The twiddle (acc[4i ..]: yr(b), yr(b + 1), yi(b), yi(b + 1) at k2 row
      // 32 w + 8 warp + g), split, into T: Tr at K = b, Ti at n1 + b.
      const int k2l = 32 * w + 8 * warp + g;
      const float2* tw_row = twiddle + static_cast<long long>(k0 + k2l) * N1;
#pragma unroll
      for (int i = 0; i < NP / 8; ++i) {
        const int b = h * NP + 8 * i + 2 * tig;
        const float4 tw = *reinterpret_cast<const float4*>(tw_row + b);
        const float* y = acc + 4 * i;
        const float tr0 = __fsub_rn(__fmul_rn(y[0], tw.x), __fmul_rn(y[2], tw.y));
        const float ti0 = __fadd_rn(__fmul_rn(y[0], tw.y), __fmul_rn(y[2], tw.x));
        const float tr1 = __fsub_rn(__fmul_rn(y[1], tw.z), __fmul_rn(y[3], tw.w));
        const float ti1 = __fadd_rn(__fmul_rn(y[1], tw.w), __fmul_rn(y[3], tw.z));
        unsigned cr[C2], ci[C2];
        split_bf16x2<C2>(tr0, tr1, cr);
        split_bf16x2<C2>(ti0, ti1, ci);
#pragma unroll
        for (int c = 0; c < C2; ++c) {
          *reinterpret_cast<unsigned*>(ts + (c * KT2 + (b >> 6)) * T_TILE + sw128(k2l, b & 63)) =
              cr[c];
          *reinterpret_cast<unsigned*>(ts + (c * KT2 + ((N1 + b) >> 6)) * T_TILE +
                                       sw128(k2l, (N1 + b) & 63)) = ci[c];
        }
      }
    }
    fence_async_shared();
    asm volatile("bar.sync 1, 256;" ::: "memory");  // T is whole

    // Stage 2: [Zr Zi] of this warpgroup's columns = T tab2, K tile by K tile;
    // warpgroup 2 of a frame's first unit also bin n / 2's columns.
    float acc2[NB / 2], accn[4];
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) acc2[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) accn[i] = 0.f;
    const bool nyquist = blk == 0 && w == 1;
    for (int kt = 0; kt < KT2; ++kt, ++seq) {
      const int slot = static_cast<int>(seq % D);
      gemm_wait(full + slot, static_cast<unsigned>((seq / D) & 1));
      const unsigned bt = ring_addr + slot * SLOT, at = ts_addr + kt * T_TILE;
      fence_operands(acc2);
      fence_operands(accn);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int ca = 0; ca < C2; ++ca)
#pragma unroll
          for (int cb = 0; cb < C2; ++cb) {
            if (!tier_term(P2, ca, cb)) continue;
            Wgmma<NB>::mma(acc2, sw128_desc(at + ca * KT2 * T_TILE, j),
                           sw128_desc(bt + cb * B_CHUNK + w * NB * 128, j));
          }
      if (nyquist) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int ca = 0; ca < C2; ++ca)
#pragma unroll
            for (int cb = 0; cb < C2; ++cb) {
              if (!tier_term(P2, ca, cb)) continue;
              Wgmma<8>::mma(accn, sw128_desc(at + ca * KT2 * T_TILE, j),
                            sw128_desc(bt + cb * B_CHUNK + N1 * 128, j));
            }
      }
      wgmma_commit();
      fence_operands(acc2);
      fence_operands(accn);
      wgmma_wait<0>();
      fence_operands(acc2);
      fence_operands(accn);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);
    }

    // |Z|^2 (acc2[4i + 2hh + e]: k2 = k0 + 16 warp + lane / 4 + 8 hh, k1 =
    // n1 / 4 w + 4 i + lane mod 4; e = 0 Zr, 1 Zi) to bin n2 k1 + k2, bin
    // n / 2 from accn.
    float* o = out + f * (n_half + 1LL) + k0 + 16 * warp + (lane >> 2);
#pragma unroll
    for (int i = 0; i < NB / 8; ++i) {
      const int k1 = NB / 2 * w + 4 * i + (lane & 3);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        o[n2 * k1 + 8 * hh] = tier_power(acc2[4 * i + 2 * hh], acc2[4 * i + 2 * hh + 1]);
    }
    if (nyquist && warp == 0 && lane == 0)
      out[f * (n_half + 1LL) + n_half] = tier_power(accn[0], accn[1]);
  }
}

// tier_fused_kernel over a group (s.g frames) at n1 = N1 and inner / outer
// passes P1, P2: a CTA an SM walking the units.
template <int N1, int P1, int P2>
int launch_fused(const unsigned char* x, const unsigned char* tab1, const unsigned char* tab2,
                 const float2* twiddle, float* out, const GemmShape& s, int device,
                 cudaStream_t stream) {
  constexpr FusedShape shape = fused_shape(N1, P1, P2);
  static_assert(shape.np > 0 && shape.smem <= 232448, "tier_fused_kernel: shared memory");
  const auto kernel = tier_fused_kernel<P1, P2, N1>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shape.smem);
  if (err != cudaSuccess) return err;
  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long units = s.g * (s.n2() / kFusedRows);
  kernel<<<static_cast<unsigned>(units < n_sm ? units : n_sm), kFusedThreads, shape.smem,
           stream>>>(x, tab1, tab2, twiddle, out, s);
  return cudaGetLastError();
}

#endif  // the tier GEMMs

#ifndef SED_FEATURIZER_ONE_TIER_UNIT
// The rows a K2 CTA sums at once over `rows` rows on a card of n_sm SMs:
// kMelRows once every SM has a group of them and their segment sums fit
// beside the ring (above n_fft 524288 they do not: 3,897 segments at 2^20);
// one row at a time otherwise (the streaming tick's 160 rows: one wave of
// CTAs).  launch_mel_log_mode launches by it, sed_mel_plan reports it.
constexpr int mel_rows_at_once(long long rows, int n_seg, int n_mels, int n_sm) {
  return rows >= static_cast<long long>(kMelRows) * n_sm &&
                 mel_smem_bytes<kMelRows>(n_seg, n_mels) <= 232448
             ? kMelRows
             : 1;
}

// K2 at product mode `passes` (mel_fma) on the current device, at
// mel_rows_at_once rows a CTA.
int launch_mel_log_mode(const MelArgs& args, int passes, int device, cudaStream_t s) {
  int n_sm = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const bool many = mel_rows_at_once(args.rows, args.n_seg, args.n_mels, n_sm) == kMelRows;
  switch (passes) {
    case 0:
      return many ? launch_mel_log<kMelRows>(args, n_sm, s) : launch_mel_log<1>(args, n_sm, s);
    case 1:
      return many ? launch_mel_log<kMelRows, 1>(args, n_sm, s)
                  : launch_mel_log<1, 1>(args, n_sm, s);
    case 3:
      return many ? launch_mel_log<kMelRows, 3>(args, n_sm, s)
                  : launch_mel_log<1, 3>(args, n_sm, s);
    default:
      return cudaErrorInvalidValue;
  }
}
#endif  // SED_FEATURIZER_ONE_TIER_UNIT

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

// K6t at n1 128 and 256 (log2_m 14..16): their instances are the wide
// packed object's (-DSED_FEATURIZER_WIDE_PACKED_ONLY), reached from
// sed_tier_packed_fft on the current device.
int launch_wide_packed_fft(const void* wave, const void* window, const void* tab1,
                           const void* tab2, const void* twiddle, void* out_re, void* out_im,
                           long long rows, long long n_samples, int n_frames, int hop, int log2_m,
                           int inner_passes, int outer_passes, void* stream);

#if !defined(SED_FEATURIZER_NO_TIERS) && \
    (!defined(SED_FEATURIZER_ONE_TIER_UNIT) || defined(SED_FEATURIZER_WIDE_PACKED_ONLY))
int launch_wide_packed_fft(const void* wave, const void* window, const void* tab1,
                           const void* tab2, const void* twiddle, void* out_re, void* out_im,
                           long long rows, long long n_samples, int n_frames, int hop, int log2_m,
                           int inner_passes, int outer_passes, void* stream) {
  return launch_packed_fft<14, 16>(wave, window, tab1, tab2, twiddle, out_re, out_im, rows,
                                   n_samples, n_frames, hop, log2_m, inner_passes, outer_passes,
                                   stream);
}
#endif

extern "C" {

#ifndef SED_FEATURIZER_ONE_TIER_UNIT
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

// K2 at product mode `passes` (mel_fma: 0 f32, 1 bf16x1, 3 bf16x3).
int sed_mel_log(const void* power, const void* segments, const void* band_first,
                const void* work, const void* weights, void* out, long long rows, int n_bins,
                int n_mels, int n_seg, int span_lo, int span_hi, int passes, int device,
                void* stream) {
  const DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return guard.status();
  const MelArgs args{static_cast<const float*>(power), static_cast<const int4*>(segments),
                     static_cast<const int*>(band_first), static_cast<const int*>(work),
                     static_cast<const float*>(weights), static_cast<float*>(out), rows,
                     n_bins, n_mels, n_seg, span_lo, span_hi};
  return launch_mel_log_mode(args, passes, device, static_cast<cudaStream_t>(stream));
}

// K2's plan for `rows` rows of n_seg segments and n_mels bands on `device`,
// as sed_mel_log launches it: the rows a CTA sums at once
// (mel_rows_at_once) and its dynamic shared memory (mel_smem_bytes).
// cuda_featurizer.launch_plan reads it; it launches nothing.
int sed_mel_plan(long long rows, int n_seg, int n_mels, int device, int* rows_at_once,
                 long long* smem) {
  int n_sm = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *rows_at_once = mel_rows_at_once(rows, n_seg, n_mels, n_sm);
  *smem = *rows_at_once == kMelRows ? mel_smem_bytes<kMelRows>(n_seg, n_mels)
                                    : mel_smem_bytes<1>(n_seg, n_mels);
  return cudaSuccess;
}

int sed_wave_stft_mel_log(const void* wave, const void* window, const void* twiddle,
                          const void* unpack, const void* segments, const void* band_first,
                          const void* weights, void* out, long long n_signals,
                          long long n_samples, int n_frames, int hop, int log2_m, int n_mels,
                          int n_seg, int mel_passes, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return guard.status();
  if (mel_passes != 0 && mel_passes != 1 && mel_passes != 3) return cudaErrorInvalidValue;
  const auto* w = static_cast<const float*>(wave);
  const auto* win = static_cast<const float*>(window);
  const auto* tw = static_cast<const float2*>(twiddle);
  const auto* unpack_tw = static_cast<const float2*>(unpack);
  const auto* seg = static_cast<const int4*>(segments);
  const auto* first = static_cast<const int*>(band_first);
  const auto* fb = static_cast<const float*>(weights);
  auto* mel = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  return with_log2_m(log2_m, [&](auto log2_m_constant) {
    constexpr int L = decltype(log2_m_constant)::value;
    // The one-sided power (m + 1 floats), the segment sums and the loads'
    // slack, after the exchange buffer; in a cluster's CTA its M + 1 bins and
    // the segment sums.
    const int extra = static_cast<int>(sizeof(float)) *
                      (kClusterCtas<L> == 1 ? (1 << L) + 1 + n_seg + kSegBins
                                            : (1 << kCtaLog2M) + 1 + n_seg);
    return launch_stockham<L>(wave_stft_mel_log_kernel<L>, n_signals * n_frames, extra, s, w,
                              win, tw, unpack_tw, seg, first, fb, mel, n_samples, n_frames, hop,
                              n_mels, n_seg, mel_passes);
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

// Above n_fft 131072 (log2_m 17..19), K1's, K3's and K6's first launch: the
// cross pass of `rows` frames (kind as TierSource: 0 waveforms, as K1 and K6
// frame them; 1, 2 rows of f32 or int16, as K3 reads them) into R = 2^(log2_m
// - 16) sub-rows a frame of out ((rows, m) complex).  cross: the host's
// cross_pass_twiddles(n_fft).
int sed_fft_cross_pass(const void* data, int kind, const void* window, const void* cross,
                       void* out, long long rows, long long n_samples, int n_frames, int hop,
                       int log2_m, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return guard.status();
  if (kind < 0 || kind > 2) return cudaErrorInvalidValue;
  const long long blocks = rows << (kSubLog2M - 8);  // kPassThreads = 2^8 a block
  if (blocks < 1 || blocks > 2147483647LL) return cudaErrorInvalidValue;
  const TierSource src{data, static_cast<const float*>(window), n_samples, n_frames, hop, kind};
  const auto* tw = static_cast<const float2*>(cross);
  auto* z = static_cast<float2*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto grid = static_cast<unsigned>(blocks);
  switch (log2_m) {
    case 17: fft_cross_pass_kernel<2><<<grid, kPassThreads, 0, s>>>(src, tw, z); break;
    case 18: fft_cross_pass_kernel<4><<<grid, kPassThreads, 0, s>>>(src, tw, z); break;
    case 19: fft_cross_pass_kernel<8><<<grid, kPassThreads, 0, s>>>(src, tw, z); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The second launch: cluster_fft of `sub_rows` rows of 2^16 complex points
// (2^log2_r a frame), in place (natural 0: K1, K3) or to out_re / out_im
// ((frames, 2^(16 + log2_r)) f32 each, bin s + R k: K6).  twiddle: K1's
// stockham_twiddles table at n_fft 131072.
int sed_fft_subrows(void* rows, const void* twiddle, void* out_re, void* out_im,
                    long long sub_rows, int log2_r, int natural, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return guard.status();
  if (log2_r < 1 || log2_r > 3) return cudaErrorInvalidValue;
  auto* z = static_cast<float2*>(rows);
  const auto* tw = static_cast<const float2*>(twiddle);
  auto* re = static_cast<float*>(out_re);
  auto* im = static_cast<float*>(out_im);
  const auto s = static_cast<cudaStream_t>(stream);
  return natural ? launch_stockham<kSubLog2M>(fft_subrows_kernel<true>, sub_rows, 0, s, z, tw,
                                              re, im, log2_r)
                 : launch_stockham<kSubLog2M>(fft_subrows_kernel<false>, sub_rows, 0, s, z, tw,
                                              re, im, log2_r);
}

// K1's and K3's third launch: (rows, m + 1) one-sided power from the sub-rows'
// Z ((rows, m) complex, 2^log2_r sub-rows a frame).  unpack: W_N^k, k < m.
int sed_packed_power(const void* z, const void* unpack, void* out, long long rows, int log2_m,
                     int log2_r, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return guard.status();
  if (log2_m < 17 || log2_m > 19 || log2_r != log2_m - kSubLog2M) return cudaErrorInvalidValue;
  const int per_row = ((1 << log2_m) + kPassThreads) / kPassThreads;  // m + 1 bins
  const long long blocks = rows * per_row;
  if (blocks < 1 || blocks > 2147483647LL) return cudaErrorInvalidValue;
  packed_power_kernel<<<static_cast<unsigned>(blocks), kPassThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(z), static_cast<const float2*>(unpack), static_cast<float*>(out),
      log2_m, log2_r, per_row);
  return cudaGetLastError();
}

#endif  // SED_FEATURIZER_ONE_TIER_UNIT

#if !defined(SED_FEATURIZER_NO_TIERS) && \
    (!defined(SED_FEATURIZER_ONE_TIER_UNIT) || defined(SED_FEATURIZER_GEMM_TIERS_ONLY))
// The tier GEMMs of `frames` frames of an n1 n2-point DFT (log2_n1 3..10,
// log2_n2 4..10, n1 <= n2), packed (K6t) or not, at inner / outer passes
// (1, 3, 4, 6); each entry takes one group of frames (sed_tier_gemm_plan).
//
// The plan at `frames` frames, as the three entries launch them: plan[0]
// frames a group (kGemmScratch), [1] the bytes of a group's planes (X, then
// T), [2] X's bytes, [3] tab1's rows, [4] tab2's rows (the tables' padding to
// the tiles), [5] [6] stage 1's and stage 2's dynamic shared memory.
// cuda_featurizer.gemm_plan reads it; it launches nothing.
int sed_tier_gemm_plan(int log2_n1, int log2_n2, int packed, int inner, int outer,
                       long long frames, long long* plan) {
  GemmShape s;
  const cudaError_t err = gemm_shape(log2_n1, log2_n2, packed, inner, outer, frames, &s);
  if (err != cudaSuccess) return err;
  s.g = gemm_group(s, frames);
  const long long values[] = {s.g,           s.x_bytes() + s.t_bytes(), s.x_bytes(),
                              s.tab1_rows(), s.tab2_rows(),           gemm_smem(s.c1),
                              gemm_smem(s.c2)};
  for (int i = 0; i < 7; ++i) plan[i] = values[i];
  return cudaSuccess;
}

// K1t's and K3t's plan at n_fft 2^log2_n (11..17), inner / outer passes,
// over `frames` frames on `device`, as cuda_featurizer launches them:
// plan[0] 1 where the split pass and tier_fused_kernel run them
// (fused_route), 0 where the tier GEMMs do (n1 256, four stage-1 passes; K5t
// is either, then K2); where a fused_shape fits (whichever the route), [1]
// frames a group of the fused kernel (its X planes within kGemmScratch), [2]
// a group's X bytes, [3] tab1's and [4] tab2's rows (the tier GEMMs'
// tables), [5] threads, [6] dynamic shared memory, [7] k2 rows a unit, [8]
// stage 1's columns a pass, [9] ring slots, [10] CTAs over a group; else
// 0.  It launches nothing.
int sed_tier_fused_plan(int log2_n, int inner, int outer, long long frames, int device,
                        long long* plan) {
  for (int i = 0; i < 11; ++i) plan[i] = 0;
  if (log2_n < 11 || log2_n > 17) return cudaErrorInvalidValue;
  GemmShape s;
  cudaError_t err = gemm_shape(log2_n / 2, log2_n - log2_n / 2, 0, inner, outer, frames, &s);
  if (err != cudaSuccess) return err;
  const FusedShape shape = fused_shape(s.n1(), inner, outer);
  if (shape.np == 0) return cudaSuccess;
  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  s.g = fused_group(s, frames);
  const long long units = s.g * (s.n2() / kFusedRows);
  const long long values[] = {fused_route(s.n1(), inner, outer) ? 1 : 0,
                              s.g,
                              s.x_bytes(),
                              s.tab1_rows(),
                              s.tab2_rows(),
                              kFusedThreads,
                              shape.smem,
                              kFusedRows,
                              shape.np,
                              shape.slots,
                              units < n_sm ? units : n_sm};
  for (int i = 0; i < 11; ++i) plan[i] = values[i];
  return cudaSuccess;
}

// The split pass: frames row0 .. row0 + frames - 1 of the source (kind as
// TierSource; packed: K6t's packed points of waveforms, kind 0) into the X
// planes at x (the group's first sed_tier_gemm_plan plan[2] bytes).
int sed_tier_split(const void* data, int kind, const void* window, void* x, long long row0,
                   long long frames, long long n_samples, int n_frames, int hop, int log2_n1,
                   int log2_n2, int packed, int inner, int outer, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return guard.status();
  GemmShape s;
  const cudaError_t err = gemm_shape(log2_n1, log2_n2, packed, inner, outer, frames, &s);
  if (err != cudaSuccess) return err;
  if (kind < 0 || kind > 2 || (packed && kind != 0) || row0 < 0) return cudaErrorInvalidValue;
  const long long blocks = ((frames << log2_n1) + 63) / 64 *
                           (packed ? (s.n2() + 63) / 64 : s.kt1());
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  const TierSource src{data, static_cast<const float*>(window), n_samples, n_frames, hop, kind};
  auto* planes = static_cast<unsigned char*>(x);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto launch = [&](auto kernel) {
    kernel<<<static_cast<unsigned>(blocks), kSplitThreads, 0, st>>>(src, planes, row0, s);
    return static_cast<int>(cudaGetLastError());
  };
  switch (s.c1 + 4 * packed) {
    case 1: return launch(tier_split_kernel<1, false>);
    case 2: return launch(tier_split_kernel<2, false>);
    case 3: return launch(tier_split_kernel<3, false>);
    case 5: return launch(tier_split_kernel<1, true>);
    case 6: return launch(tier_split_kernel<2, true>);
    default: return launch(tier_split_kernel<3, true>);
  }
}

// Stage 1 of a group: the X planes at x by tab1 (the C1 chunks of
// cuda_featurizer._gemm_images' image), the twiddle (n2, n1) float2, to the
// T planes at t (plan[2] bytes after x).
int sed_tier_inner(const void* x, const void* tab1, const void* twiddle, void* t,
                   long long frames, int log2_n1, int log2_n2, int packed, int inner, int outer,
                   int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return guard.status();
  GemmShape s;
  const cudaError_t err = gemm_shape(log2_n1, log2_n2, packed, inner, outer, frames, &s);
  if (err != cudaSuccess) return err;
  const long long tiles = s.tab1_rows() / kGemmBM * (s.x_rows() / gemm_bn(s.c1));
  const auto* xp = static_cast<const unsigned char*>(x);
  const auto* t1 = static_cast<const unsigned char*>(tab1);
  const auto* tw = static_cast<const float2*>(twiddle);
  auto* tp = static_cast<unsigned char*>(t);
  const auto st = static_cast<cudaStream_t>(stream);
  return with_passes(inner, [&](auto p_constant) {
    constexpr int P = decltype(p_constant)::value;
    constexpr int smem = gemm_smem(tier_chunks(P));
    const auto launch = [&](auto kernel) {
      return launch_gemm(kernel, smem, tiles, device, st, xp, t1, tw, tp, s);
    };
    return s.c2 == 1   ? launch(tier_inner_kernel<P, 1>)
           : s.c2 == 2 ? launch(tier_inner_kernel<P, 2>)
                       : launch(tier_inner_kernel<P, 3>);
  });
}

// Stage 2 of a group: the T planes at t by tab2, to out (frames, n/2 + 1)
// power, or (packed) out and out_im (frames, n) Zr and Zi.
int sed_tier_outer(const void* t, const void* tab2, void* out, void* out_im, long long frames,
                   int log2_n1, int log2_n2, int packed, int inner, int outer, int device,
                   void* stream) {
  const DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return guard.status();
  GemmShape s;
  const cudaError_t err = gemm_shape(log2_n1, log2_n2, packed, inner, outer, frames, &s);
  if (err != cudaSuccess) return err;
  const long long tiles = s.t_rows() / kGemmBM * (s.tab2_rows() / gemm_bn(s.c2));
  const auto* tp = static_cast<const unsigned char*>(t);
  const auto* t2 = static_cast<const unsigned char*>(tab2);
  auto* re = static_cast<float*>(out);
  auto* im = static_cast<float*>(out_im);
  const auto st = static_cast<cudaStream_t>(stream);
  return with_passes(outer, [&](auto p_constant) {
    constexpr int P = decltype(p_constant)::value;
    constexpr int smem = gemm_smem(tier_chunks(P));
    return packed ? launch_gemm(tier_outer_kernel<P, true>, smem, tiles, device, st, tp, t2, re,
                                im, s)
                  : launch_gemm(tier_outer_kernel<P, false>, smem, tiles, device, st, tp, t2,
                                re, im, s);
  });
}
#endif

// The bf16 tier DFT's entry points.  Each kernel's instances take about as
// long to compile as the rest of the file, so the library is linked from
// five objects of this file compiled side by side
// (cuda_featurizer.BUILD_RECIPE): -DSED_FEATURIZER_TIERS_ONLY (K1t, K3t:
// tier_fused_kernel at n1 32..128), -DSED_FEATURIZER_PACKED_TIERS_ONLY (K6t
// at n1 32 and 64), -DSED_FEATURIZER_WIDE_PACKED_ONLY (K6t at n1 128 and
// 256, behind launch_wide_packed_fft), -DSED_FEATURIZER_GEMM_TIERS_ONLY (the
// split pass, the tier GEMMs and both tier plans: sed_tier_gemm_plan,
// sed_tier_fused_plan, sed_tier_split, sed_tier_inner and sed_tier_outer
// above) and -DSED_FEATURIZER_NO_TIERS (every other entry; the lesion builds
// of chip_smoke.py too).

#if !defined(SED_FEATURIZER_NO_TIERS) && \
    (!defined(SED_FEATURIZER_ONE_TIER_UNIT) || defined(SED_FEATURIZER_TIERS_ONLY))
// K1t and K3t (K5t's first part) where sed_tier_fused_plan's plan[0] is 1:
// one-sided |X|^2 of a group of `frames` frames of n_fft = 2^log2_n (11..15)
// to out ((frames, n_fft / 2 + 1) f32) by tier_fused_kernel at inner_passes
// / outer_passes (1, 3, 4, 6; any whose fused_shape fits), from the group's
// X planes at x (sed_tier_split: K1's framing or K3's rows), the tier GEMMs'
// tables tab1 and tab2 and the (n2, n1) twiddles.
int sed_tier_dft_power(const void* x, const void* tab1, const void* tab2, const void* twiddle,
                       void* out, long long frames, int log2_n, int inner_passes,
                       int outer_passes, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return guard.status();
  GemmShape s;
  const cudaError_t err =
      gemm_shape(log2_n / 2, log2_n - log2_n / 2, 0, inner_passes, outer_passes, frames, &s);
  if (err != cudaSuccess) return err;
  const auto* xp = static_cast<const unsigned char*>(x);
  const auto* t1 = static_cast<const unsigned char*>(tab1);
  const auto* t2 = static_cast<const unsigned char*>(tab2);
  const auto* tw = static_cast<const float2*>(twiddle);
  auto* o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  return with_tier<11, 15>(log2_n, inner_passes, outer_passes, [&](auto n1, auto p1, auto p2) {
    constexpr int N1 = decltype(n1)::value, P1 = decltype(p1)::value, P2 = decltype(p2)::value;
    return launch_fused<N1, P1, P2>(xp, t1, t2, tw, o, s, device, st);
  });
}
#endif

#if !defined(SED_FEATURIZER_NO_TIERS) && \
    (!defined(SED_FEATURIZER_ONE_TIER_UNIT) || defined(SED_FEATURIZER_PACKED_TIERS_ONLY))
// K6t: Z = DFT_m((x_even + i x_odd) * window) of the waveforms' `rows`
// centred frames of 2m samples (m = 2^log2_m, log2_m 11..16; 14..16 in the
// wide packed object) by the bf16 wgmma DFT (tier_packed_fft_kernel) at
// inner_passes / outer_passes, to out_re and out_im, each (rows, m) f32 in
// natural bin order, as K6 writes them.  Built with -DSED_FEATURIZER_PACKED_ONE_SIZE=L, it holds
// the instances of log2_m L alone (chip_smoke.py's lesion builds).
int sed_tier_packed_fft(const void* wave, const void* window, const void* tab1,
                        const void* tab2, const void* twiddle, void* out_re, void* out_im,
                        long long rows, long long n_samples, int n_frames, int hop, int log2_m,
                        int inner_passes, int outer_passes, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return guard.status();
#ifdef SED_FEATURIZER_PACKED_ONE_SIZE
  return launch_packed_fft<SED_FEATURIZER_PACKED_ONE_SIZE, SED_FEATURIZER_PACKED_ONE_SIZE>(
      wave, window, tab1, tab2, twiddle, out_re, out_im, rows, n_samples, n_frames, hop, log2_m,
      inner_passes, outer_passes, stream);
#else
  if (log2_m > 13)
    return launch_wide_packed_fft(wave, window, tab1, tab2, twiddle, out_re, out_im, rows,
                                  n_samples, n_frames, hop, log2_m, inner_passes, outer_passes,
                                  stream);
  return launch_packed_fft<11, 13>(wave, window, tab1, tab2, twiddle, out_re, out_im, rows,
                                   n_samples, n_frames, hop, log2_m, inner_passes, outer_passes,
                                   stream);
#endif
}
#endif

}  // extern "C"
