// Self-contained GIF87a/89a decoder — native fast path for TGIF ingest.
//
// The reference decodes GIFs through OpenCV/FFmpeg per sample per epoch
// (reference lrce/dataset/e2e_dataset.py:76-84). This decoder implements the
// GIF spec directly (no external codec deps): LZW decompression, local/global
// color tables, interlacing, frame composition with disposal methods 0/1
// (leave), 2 (restore to background), 3 (restore to previous), and
// transparency. Output is a dense (n_frames, H, W, 3) RGB buffer.
//
// C ABI:
//   int gif_probe(const char* path, int* out_w, int* out_h, int* out_frames);
//   int gif_decode(const char* path, unsigned char* out, int max_frames);
//     `out` must hold max_frames*H*W*3 bytes; returns frames written, <0 err.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Reader {
  FILE* f = nullptr;
  bool ok = true;

  explicit Reader(const char* path) { f = std::fopen(path, "rb"); }
  ~Reader() {
    if (f) std::fclose(f);
  }
  uint8_t u8() {
    int c = std::fgetc(f);
    if (c == EOF) {
      ok = false;
      return 0;
    }
    return (uint8_t)c;
  }
  uint16_t u16() {
    uint16_t lo = u8(), hi = u8();
    return (uint16_t)(lo | (hi << 8));
  }
  void read(uint8_t* dst, size_t n) {
    if (std::fread(dst, 1, n, f) != n) ok = false;
  }
  void skip(long n) {
    if (std::fseek(f, n, SEEK_CUR) != 0) ok = false;
  }
  void skip_subblocks() {
    while (ok) {
      uint8_t n = u8();
      if (n == 0) break;
      skip(n);
    }
  }
  std::vector<uint8_t> read_subblocks() {
    std::vector<uint8_t> out;
    while (ok) {
      uint8_t n = u8();
      if (n == 0) break;
      size_t off = out.size();
      out.resize(off + n);
      read(out.data() + off, n);
    }
    return out;
  }
};

// LZW decode of GIF image data. Returns index stream.
bool lzw_decode(const std::vector<uint8_t>& data, int min_code_size,
                size_t expected, std::vector<uint8_t>& out) {
  if (min_code_size < 2 || min_code_size > 11) return false;
  const int clear_code = 1 << min_code_size;
  const int eoi_code = clear_code + 1;

  // dictionary: prefix chain representation
  std::vector<int> prefix(4096, -1);
  std::vector<uint8_t> suffix(4096, 0);
  std::vector<uint8_t> stack(4097);

  int code_size = min_code_size + 1;
  int next_code = eoi_code + 1;
  int prev = -1;

  uint32_t bitbuf = 0;
  int bits = 0;
  size_t pos = 0;
  out.clear();
  out.reserve(expected);

  auto reset = [&]() {
    code_size = min_code_size + 1;
    next_code = eoi_code + 1;
    prev = -1;
  };

  while (out.size() < expected) {
    while (bits < code_size) {
      if (pos >= data.size()) return out.size() >= expected;
      bitbuf |= (uint32_t)data[pos++] << bits;
      bits += 8;
    }
    int code = (int)(bitbuf & ((1u << code_size) - 1));
    bitbuf >>= code_size;
    bits -= code_size;

    if (code == clear_code) {
      reset();
      continue;
    }
    if (code == eoi_code) break;

    int sp = 0;
    int cur = code;
    if (code >= next_code) {
      // KwKwK case: output prev string + first char of prev
      if (prev < 0) return false;
      stack[sp++] = 0;  // placeholder, filled after walking prev
      cur = prev;
    }
    while (cur >= clear_code + 2) {
      if (sp >= 4096 || cur >= 4096) return false;
      stack[sp++] = suffix[cur];
      cur = prefix[cur];
    }
    uint8_t first = (uint8_t)cur;
    stack[sp++] = first;
    if (code >= next_code) stack[0] = first;

    // emit reversed
    for (int i = sp - 1; i >= 0; --i) {
      out.push_back(stack[i]);
      if (out.size() >= expected) break;
    }

    if (prev >= 0 && next_code < 4096) {
      prefix[next_code] = prev;
      suffix[next_code] = first;
      ++next_code;
      if (next_code == (1 << code_size) && code_size < 12) ++code_size;
    }
    prev = code;
  }
  return out.size() >= expected;
}

struct GifInfo {
  int width = 0, height = 0, frames = 0;
};

// Walk the GIF; when `out` != nullptr, compose frames into it.
int process_gif(const char* path, unsigned char* out, int max_frames,
                GifInfo* info) {
  Reader r(path);
  if (!r.f) return -1;
  uint8_t hdr[6];
  r.read(hdr, 6);
  if (!r.ok || std::memcmp(hdr, "GIF", 3) != 0) return -2;

  int width = r.u16(), height = r.u16();
  uint8_t packed = r.u8();
  uint8_t bg_index = r.u8();
  r.u8();  // aspect

  std::vector<uint8_t> gct;  // global color table (r,g,b)*
  if (packed & 0x80) {
    int n = 2 << (packed & 0x07);
    gct.resize((size_t)n * 3);
    r.read(gct.data(), gct.size());
  }

  const size_t canvas_size = (size_t)width * height * 3;
  std::vector<uint8_t> canvas(canvas_size, 0);
  std::vector<uint8_t> previous(canvas_size, 0);
  // initial canvas: background color (or black) — composition base
  if (!gct.empty() && (size_t)bg_index * 3 + 2 < gct.size()) {
    for (size_t i = 0; i < canvas_size; i += 3) {
      canvas[i] = gct[bg_index * 3];
      canvas[i + 1] = gct[bg_index * 3 + 1];
      canvas[i + 2] = gct[bg_index * 3 + 2];
    }
  }

  int frames = 0;
  int transparent = -1;
  int disposal = 0;

  while (r.ok) {
    uint8_t block = r.u8();
    if (!r.ok || block == 0x3B) break;  // trailer
    if (block == 0x21) {                // extension
      uint8_t label = r.u8();
      if (label == 0xF9) {  // graphic control
        r.u8();             // size (4)
        uint8_t flags = r.u8();
        r.u16();  // delay
        uint8_t t_idx = r.u8();
        r.u8();  // terminator
        disposal = (flags >> 2) & 0x07;
        transparent = (flags & 1) ? t_idx : -1;
      } else {
        r.skip_subblocks();
      }
      continue;
    }
    if (block != 0x2C) return -3;  // image descriptor expected

    int ix = r.u16(), iy = r.u16(), iw = r.u16(), ih = r.u16();
    uint8_t ipacked = r.u8();
    std::vector<uint8_t> lct;
    if (ipacked & 0x80) {
      int n = 2 << (ipacked & 0x07);
      lct.resize((size_t)n * 3);
      r.read(lct.data(), lct.size());
    }
    const std::vector<uint8_t>& ct = lct.empty() ? gct : lct;
    bool interlaced = (ipacked & 0x40) != 0;

    uint8_t min_code = r.u8();
    std::vector<uint8_t> data = r.read_subblocks();
    if (!r.ok) break;

    if (out == nullptr && info != nullptr) {
      // probe mode: still must decode composition state? No — just count.
      ++frames;
      continue;
    }
    if (frames >= max_frames) break;

    std::vector<uint8_t> indices;
    if (!lzw_decode(data, min_code, (size_t)iw * ih, indices)) return -4;

    if (disposal == 3) previous = canvas;

    // de-interlace row order
    std::vector<int> rows(ih);
    if (interlaced) {
      int rr = 0;
      for (int y = 0; y < ih; y += 8) rows[rr++] = y;
      for (int y = 4; y < ih; y += 8) rows[rr++] = y;
      for (int y = 2; y < ih; y += 4) rows[rr++] = y;
      for (int y = 1; y < ih; y += 2) rows[rr++] = y;
    } else {
      for (int y = 0; y < ih; ++y) rows[y] = y;
    }

    for (int sy = 0; sy < ih; ++sy) {
      int y = rows[sy];
      int cy = iy + y;
      if (cy < 0 || cy >= height) continue;
      for (int x = 0; x < iw; ++x) {
        int cx = ix + x;
        if (cx < 0 || cx >= width) continue;
        int idx = indices[(size_t)sy * iw + x];
        if (idx == transparent) continue;
        if ((size_t)idx * 3 + 2 >= ct.size()) continue;
        size_t o = ((size_t)cy * width + cx) * 3;
        canvas[o] = ct[idx * 3];
        canvas[o + 1] = ct[idx * 3 + 1];
        canvas[o + 2] = ct[idx * 3 + 2];
      }
    }

    std::memcpy(out + (size_t)frames * canvas_size, canvas.data(),
                canvas_size);
    ++frames;

    if (disposal == 2) {
      // restore painted region to background; FFmpeg/browsers treat the
      // background as transparent black in practice
      for (int y = 0; y < ih; ++y) {
        int cy = iy + y;
        if (cy < 0 || cy >= height) continue;
        for (int x = 0; x < iw; ++x) {
          int cx = ix + x;
          if (cx < 0 || cx >= width) continue;
          size_t o = ((size_t)cy * width + cx) * 3;
          canvas[o] = canvas[o + 1] = canvas[o + 2] = 0;
        }
      }
    } else if (disposal == 3) {
      canvas = previous;
    }
    transparent = -1;
    disposal = 0;
  }

  if (info) {
    info->width = width;
    info->height = height;
    info->frames = frames;
  }
  return frames;
}

}  // namespace

extern "C" {

int gif_probe(const char* path, int* out_w, int* out_h, int* out_frames) {
  GifInfo info;
  int rc = process_gif(path, nullptr, 0, &info);
  if (rc < 0) return rc;
  *out_w = info.width;
  *out_h = info.height;
  *out_frames = info.frames;
  return 0;
}

int gif_decode(const char* path, unsigned char* out, int max_frames) {
  GifInfo info;
  return process_gif(path, out, max_frames, &info);
}

}  // extern "C"
