// sed_native: the host-side audio acquisition layer of sed_tpu_torch.
//
// The port's own copy of the native reader: the same C ABI, bound with ctypes
// by sed_tpu_torch/io/native.py, which compiles this file at first use with
// g++ and the flags -O3 -march=native -fPIC -shared -Wall -pthread.
//   * sed_read_wav:  RIFF/WAVE decode (PCM 8/16/24/32, IEEE float32/64,
//                    WAVE_FORMAT_EXTENSIBLE) -> float32 interleaved,
//                    normalized like soundfile (int16/2^15, ...).
//   * sed_resample:  polyphase windowed-sinc (Kaiser) resampler.
//   * sed_mixdown:   interleaved -> mono mean (the audio_channels==1 policy).
//   * sed_load_multichannel_batch: the per-file acquisition pipeline
//                    (decode -> channel policy -> per-channel resample) for a
//                    list of files across a std::thread pool, outside the GIL.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <thread>
#include <vector>

extern "C" {

typedef struct {
  float* data;       // interleaved samples, malloc'd; free with sed_free
  int64_t frames;    // samples per channel
  int32_t channels;
  int32_t sample_rate;
} SedWav;

void sed_free(float* p) { free(p); }

// ---------------------------------------------------------------------------
// WAV decode
// ---------------------------------------------------------------------------

static uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
static uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8));
}

// Returns 0 on success; negative error codes otherwise.
int sed_read_wav(const char* path, SedWav* out) {
  out->data = nullptr;
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (fsize < 44) { fclose(f); return -2; }
  std::vector<uint8_t> buf((size_t)fsize);
  if (fread(buf.data(), 1, (size_t)fsize, f) != (size_t)fsize) { fclose(f); return -3; }
  fclose(f);

  const uint8_t* p = buf.data();
  if (memcmp(p, "RIFF", 4) != 0 || memcmp(p + 8, "WAVE", 4) != 0) return -4;

  uint16_t format = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  const uint8_t* data = nullptr;
  uint32_t data_len = 0;

  size_t off = 12;
  while (off + 8 <= (size_t)fsize) {
    const uint8_t* chunk = p + off;
    uint32_t clen = rd_u32(chunk + 4);
    if (memcmp(chunk, "fmt ", 4) == 0 && clen >= 16) {
      format = rd_u16(chunk + 8);
      channels = rd_u16(chunk + 10);
      rate = rd_u32(chunk + 12);
      bits = rd_u16(chunk + 22);
      if (format == 0xFFFE && clen >= 40) {
        format = rd_u16(chunk + 8 + 24);  // extensible: sub-format GUID low word
      }
    } else if (memcmp(chunk, "data", 4) == 0) {
      data = chunk + 8;
      data_len = clen;
      if ((size_t)(data - p) + data_len > (size_t)fsize)
        data_len = (uint32_t)(fsize - (data - p));
    }
    off += 8 + clen + (clen & 1);  // chunks are word-aligned
  }
  if (!data || channels == 0 || rate == 0) return -5;

  int bytes = bits / 8;
  if (bytes == 0) return -6;
  int64_t total = (int64_t)(data_len / bytes);
  int64_t frames = total / channels;
  float* outbuf = (float*)malloc(sizeof(float) * (size_t)total);
  if (!outbuf) return -7;

  if (format == 1) {  // integer PCM
    if (bits == 16) {
      for (int64_t i = 0; i < total; i++) {
        int16_t v = (int16_t)rd_u16(data + i * 2);
        outbuf[i] = (float)(v / 32768.0);
      }
    } else if (bits == 24) {
      for (int64_t i = 0; i < total; i++) {
        const uint8_t* q = data + i * 3;
        int32_t v = (int32_t)((uint32_t)q[0] << 8 | (uint32_t)q[1] << 16 |
                              (uint32_t)q[2] << 24) >> 8;
        outbuf[i] = (float)(v / 8388608.0);
      }
    } else if (bits == 32) {
      for (int64_t i = 0; i < total; i++) {
        int32_t v = (int32_t)rd_u32(data + i * 4);
        outbuf[i] = (float)(v / 2147483648.0);
      }
    } else if (bits == 8) {  // unsigned offset-binary
      for (int64_t i = 0; i < total; i++) {
        outbuf[i] = (float)(((int)data[i] - 128) / 128.0);
      }
    } else {
      free(outbuf);
      return -8;
    }
  } else if (format == 3) {  // IEEE float
    if (bits == 32) {
      memcpy(outbuf, data, sizeof(float) * (size_t)total);
    } else if (bits == 64) {
      const double* src = (const double*)data;
      for (int64_t i = 0; i < total; i++) outbuf[i] = (float)src[i];
    } else {
      free(outbuf);
      return -9;
    }
  } else {
    free(outbuf);
    return -10;
  }

  out->data = outbuf;
  out->frames = frames;
  out->channels = channels;
  out->sample_rate = (int32_t)rate;
  return 0;
}

// ---------------------------------------------------------------------------
// Mixdown: interleaved (frames, channels) -> mono mean
// ---------------------------------------------------------------------------

void sed_mixdown(const float* in, int64_t frames, int32_t channels, float* out) {
  const double inv = 1.0 / (double)channels;
  for (int64_t i = 0; i < frames; i++) {
    double acc = 0.0;
    for (int32_t c = 0; c < channels; c++) acc += in[i * channels + c];
    out[i] = (float)(acc * inv);
  }
}

// ---------------------------------------------------------------------------
// Polyphase windowed-sinc resampler (Kaiser window)
// ---------------------------------------------------------------------------

static double bessel_i0(double x) {
  // Power series; converges fast for the beta range used here.
  double sum = 1.0, term = 1.0;
  const double half_x = x / 2.0;
  for (int k = 1; k < 64; k++) {
    term *= (half_x / k) * (half_x / k);
    sum += term;
    if (term < 1e-16 * sum) break;
  }
  return sum;
}

int64_t sed_resample_len(int64_t n, int32_t up, int32_t down) {
  return (n * (int64_t)up + down - 1) / down;
}

// y[m] = up * sum_k x[k] * h(m*down - k*up), h = windowed sinc with cutoff
// pi/max(up, down), Kaiser window, half-width `half_taps` zero crossings.
int sed_resample(const float* in, int64_t n, int32_t up, int32_t down,
                 double beta, int32_t half_zero_crossings, float* out) {
  if (up <= 0 || down <= 0 || n <= 0) return -1;
  const int32_t g = up > down ? up : down;
  // FIR half-length in the up-rate domain.
  const int64_t half = (int64_t)half_zero_crossings * g;
  const double cutoff = 1.0 / (double)g;
  const double i0b = bessel_i0(beta);
  const int64_t out_len = sed_resample_len(n, up, down);

  // Precompute the filter once: h[t] for t in [-half, half].
  std::vector<double> h((size_t)(2 * half + 1));
  for (int64_t t = -half; t <= half; t++) {
    double x = (double)t * cutoff;
    double sinc = (t == 0) ? 1.0 : sin(M_PI * x) / (M_PI * x);
    double w = (double)t / (double)half;
    double kaiser = bessel_i0(beta * sqrt(1.0 - w * w > 0 ? 1.0 - w * w : 0.0)) / i0b;
    h[(size_t)(t + half)] = sinc * cutoff * (double)up * kaiser;
  }

  for (int64_t m = 0; m < out_len; m++) {
    const int64_t t0 = m * (int64_t)down;  // position in up-rate grid
    // x[k] contributes when |t0 - k*up| <= half.
    int64_t k_min = (t0 - half + up - 1) / up;
    int64_t k_max = (t0 + half) / up;
    if (k_min < 0) k_min = 0;
    if (k_max >= n) k_max = n - 1;
    double acc = 0.0;
    for (int64_t k = k_min; k <= k_max; k++) {
      acc += (double)in[k] * h[(size_t)(t0 - k * (int64_t)up + half)];
    }
    out[m] = (float)acc;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Threaded batch loader: decode -> channel policy -> resample, per file
// ---------------------------------------------------------------------------

typedef struct {
  float* data;         // interleaved (frames, channels), malloc'd; sed_free
  int64_t frames;      // samples per channel AFTER resampling
  int32_t channels;    // channels AFTER the channel policy
  int32_t sample_rate; // target_fs (or the file's own rate if no resample)
  int32_t rc;          // 0 ok; sed_read_wav/sed_resample error code otherwise
} SedAudioOut;

static int64_t gcd64(int64_t a, int64_t b) {
  while (b) { int64_t t = a % b; a = b; b = t; }
  return a;
}

// One file through the acquisition pipeline of sed_tpu_torch/io/audio.py
// read_multichannel_audio (reference: dataset/dataset_utils.py:63-86):
//   decode; channel policy (fewer channels than requested -> repeat the mean
//   channel; audio_channels==1 -> mono mean; more -> truncate); per-channel
//   polyphase resample to target_fs when the rates differ.
static void load_one(const char* path, int32_t audio_channels,
                     int32_t target_fs, double beta,
                     int32_t half_zero_crossings, SedAudioOut* out) {
  out->data = nullptr;
  out->frames = 0;
  out->channels = 0;
  out->sample_rate = 0;
  SedWav wav;
  int rc = sed_read_wav(path, &wav);
  if (rc != 0) { out->rc = rc; return; }

  // Channel policy into a planar scratch buffer (channel-major) so the
  // per-channel resampler reads contiguous rows.
  int32_t out_ch;
  std::vector<float> planar;
  if (wav.channels < audio_channels) {
    out_ch = audio_channels;
    planar.resize((size_t)out_ch * (size_t)wav.frames);
    sed_mixdown(wav.data, wav.frames, wav.channels, planar.data());
    for (int32_t c = 1; c < out_ch; c++)
      memcpy(planar.data() + (size_t)c * wav.frames, planar.data(),
             sizeof(float) * (size_t)wav.frames);
  } else if (audio_channels == 1) {
    out_ch = 1;
    planar.resize((size_t)wav.frames);
    sed_mixdown(wav.data, wav.frames, wav.channels, planar.data());
  } else {
    out_ch = audio_channels;  // truncate (or keep all when equal)
    planar.resize((size_t)out_ch * (size_t)wav.frames);
    for (int32_t c = 0; c < out_ch; c++)
      for (int64_t i = 0; i < wav.frames; i++)
        planar[(size_t)c * wav.frames + i] = wav.data[i * wav.channels + c];
  }
  free(wav.data);

  int64_t frames = wav.frames;
  int32_t rate = wav.sample_rate;
  if (target_fs > 0 && rate != target_fs) {
    int64_t g = gcd64(target_fs, rate);
    int32_t up = (int32_t)(target_fs / g), down = (int32_t)(rate / g);
    int64_t out_len = sed_resample_len(frames, up, down);
    std::vector<float> res((size_t)out_ch * (size_t)out_len);
    for (int32_t c = 0; c < out_ch; c++) {
      rc = sed_resample(planar.data() + (size_t)c * frames, frames, up, down,
                        beta, half_zero_crossings,
                        res.data() + (size_t)c * out_len);
      if (rc != 0) { out->rc = rc; return; }
    }
    planar.swap(res);
    frames = out_len;
    rate = target_fs;
  }

  float* inter = (float*)malloc(sizeof(float) * (size_t)out_ch * (size_t)frames);
  if (!inter) { out->rc = -7; return; }
  for (int64_t i = 0; i < frames; i++)
    for (int32_t c = 0; c < out_ch; c++)
      inter[i * out_ch + c] = planar[(size_t)c * frames + i];
  out->data = inter;
  out->frames = frames;
  out->channels = out_ch;
  out->sample_rate = rate;
  out->rc = 0;
}

// Load n_files files concurrently on n_threads std::threads (work-stealing
// over an atomic index).  Every entry of `outs` is written; per-file failures
// land in outs[i].rc without aborting the batch.  Returns the count of
// failed files (0 = all good).  Call sed_free on each outs[i].data.
int sed_load_multichannel_batch(const char** paths, int32_t n_files,
                                int32_t audio_channels, int32_t target_fs,
                                double beta, int32_t half_zero_crossings,
                                int32_t n_threads, SedAudioOut* outs) {
  if (n_files <= 0) return 0;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_files) n_threads = n_files;
  std::atomic<int32_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= n_files) return;
      load_one(paths[i], audio_channels, target_fs, beta,
               half_zero_crossings, &outs[i]);
    }
  };
  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve((size_t)n_threads);
    for (int32_t t = 0; t < n_threads; t++) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  int failed = 0;
  for (int32_t i = 0; i < n_files; i++)
    if (outs[i].rc != 0) failed++;
  return failed;
}

}  // extern "C"
