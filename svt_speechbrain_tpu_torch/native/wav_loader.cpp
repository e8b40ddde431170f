// Native audio I/O for the host-side data loader.
//
// The reference's data path rides torch's C++ DataLoader workers and
// torchaudio's native decoders (SURVEY.md §3.5: loader workers execute the
// whole dynamic-item pipeline CPU-side). This library is the port's native
// equivalent for the hot loader ops: RIFF/WAV parsing, PCM decode
// with normalization, and sliced reads (utterance chunking) without
// materializing whole songs.
//
// C ABI (ctypes-friendly):
//   wav_info(path, &frames, &sample_rate, &channels, &bits, &is_float)
//   wav_read(path, start_frame, n_frames, out /* float32 [n*C] */)
//   wav_read_int16(path, start_frame, n_frames, out /* int16, mono-mixed */)
// All return 0 on success, negative error codes otherwise.
//
// Build: g++ -O3 -shared -fPIC -o build/native/libsvtnative-<hash>.so \
//        wav_loader.cpp  (svt_speechbrain_tpu_torch/native/__init__.py)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct WavMeta {
  uint16_t format = 0;       // 1 = PCM, 3 = IEEE float
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
  long data_offset = 0;      // byte offset of the data payload
  uint32_t data_bytes = 0;
};

int parse_header(FILE* f, WavMeta* meta) {
  char tag[4];
  uint32_t size = 0;
  if (fread(tag, 1, 4, f) != 4 || memcmp(tag, "RIFF", 4) != 0) return -2;
  if (fread(&size, 4, 1, f) != 1) return -2;
  if (fread(tag, 1, 4, f) != 4 || memcmp(tag, "WAVE", 4) != 0) return -2;

  while (fread(tag, 1, 4, f) == 4 && fread(&size, 4, 1, f) == 1) {
    if (memcmp(tag, "fmt ", 4) == 0) {
      unsigned char fmt[16];
      if (size < 16 || fread(fmt, 1, 16, f) != 16) return -3;
      memcpy(&meta->format, fmt + 0, 2);
      memcpy(&meta->channels, fmt + 2, 2);
      memcpy(&meta->sample_rate, fmt + 4, 4);
      memcpy(&meta->bits, fmt + 14, 2);
      if (size > 16) fseek(f, size - 16, SEEK_CUR);
      // WAVE_FORMAT_EXTENSIBLE: treat like PCM/float by bits
      if (meta->format == 0xFFFE) meta->format = (meta->bits == 32) ? 3 : 1;
    } else if (memcmp(tag, "data", 4) == 0) {
      meta->data_offset = ftell(f);
      meta->data_bytes = size;
      return 0;
    } else {
      fseek(f, size + (size & 1), SEEK_CUR);  // chunks are word-aligned
    }
  }
  return -4;
}

}  // namespace

extern "C" {

int wav_info(const char* path, int64_t* frames, int32_t* sample_rate,
             int32_t* channels, int32_t* bits, int32_t* is_float) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavMeta meta;
  int rc = parse_header(f, &meta);
  fclose(f);
  if (rc != 0) return rc;
  if (meta.channels == 0 || meta.bits == 0) return -5;
  const uint32_t frame_bytes = meta.channels * (meta.bits / 8);
  *frames = frame_bytes ? (int64_t)(meta.data_bytes / frame_bytes) : 0;
  *sample_rate = (int32_t)meta.sample_rate;
  *channels = (int32_t)meta.channels;
  *bits = (int32_t)meta.bits;
  *is_float = meta.format == 3 ? 1 : 0;
  return 0;
}

// Read n_frames starting at start_frame into out (float32, interleaved
// channels, normalized to [-1, 1] for integer PCM).
int wav_read(const char* path, int64_t start_frame, int64_t n_frames,
             float* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavMeta meta;
  int rc = parse_header(f, &meta);
  if (rc != 0) { fclose(f); return rc; }
  const uint32_t bytes_per_sample = meta.bits / 8;
  const uint32_t frame_bytes = meta.channels * bytes_per_sample;
  const int64_t total_frames = meta.data_bytes / frame_bytes;
  if (start_frame < 0) start_frame = 0;
  if (start_frame + n_frames > total_frames) n_frames = total_frames - start_frame;
  if (n_frames <= 0) { fclose(f); return 0; }

  fseek(f, meta.data_offset + start_frame * (int64_t)frame_bytes, SEEK_SET);
  const int64_t n_samples = n_frames * meta.channels;
  std::vector<unsigned char> buf((size_t)(n_samples * bytes_per_sample));
  const size_t got = fread(buf.data(), 1, buf.size(), f);
  fclose(f);
  const int64_t got_samples = (int64_t)(got / bytes_per_sample);

  if (meta.format == 3 && meta.bits == 32) {
    memcpy(out, buf.data(), (size_t)got_samples * 4);
  } else if (meta.format == 1 && meta.bits == 16) {
    const int16_t* p = reinterpret_cast<const int16_t*>(buf.data());
    for (int64_t i = 0; i < got_samples; ++i) out[i] = p[i] / 32768.0f;
  } else if (meta.format == 1 && meta.bits == 32) {
    const int32_t* p = reinterpret_cast<const int32_t*>(buf.data());
    for (int64_t i = 0; i < got_samples; ++i) out[i] = p[i] / 2147483648.0f;
  } else if (meta.format == 1 && meta.bits == 8) {
    const unsigned char* p = buf.data();
    for (int64_t i = 0; i < got_samples; ++i) out[i] = (p[i] - 128) / 128.0f;
  } else if (meta.format == 1 && meta.bits == 24) {
    const unsigned char* p = buf.data();
    for (int64_t i = 0; i < got_samples; ++i) {
      int32_t v = (p[3 * i] << 8) | (p[3 * i + 1] << 16) | (p[3 * i + 2] << 24);
      out[i] = (v >> 8) / 8388608.0f;
    }
  } else {
    return -6;
  }
  return (int)(got_samples / meta.channels);
}

// Mono-mixed int16 read: feeds the inference pipeline's int16 device path
// (half the host-link bytes) without an intermediate float conversion.
int wav_read_int16(const char* path, int64_t start_frame, int64_t n_frames,
                   int16_t* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavMeta meta;
  int rc = parse_header(f, &meta);
  if (rc != 0) { fclose(f); return rc; }
  if (!(meta.format == 1 && meta.bits == 16)) { fclose(f); return -6; }
  const uint32_t frame_bytes = meta.channels * 2;
  const int64_t total_frames = meta.data_bytes / frame_bytes;
  if (start_frame < 0) start_frame = 0;
  if (start_frame + n_frames > total_frames) n_frames = total_frames - start_frame;
  if (n_frames <= 0) { fclose(f); return 0; }
  fseek(f, meta.data_offset + start_frame * (int64_t)frame_bytes, SEEK_SET);
  std::vector<int16_t> buf((size_t)(n_frames * meta.channels));
  const size_t got = fread(buf.data(), 2, buf.size(), f) / meta.channels;
  fclose(f);
  if (meta.channels == 1) {
    memcpy(out, buf.data(), got * 2);
  } else {
    for (size_t i = 0; i < got; ++i) {
      int32_t acc = 0;
      for (uint32_t c = 0; c < meta.channels; ++c) acc += buf[i * meta.channels + c];
      out[i] = (int16_t)(acc / (int32_t)meta.channels);
    }
  }
  return (int)got;
}

}  // extern "C"
