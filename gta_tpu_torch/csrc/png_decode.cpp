// Host PNG decoder for the port's dataset readers: C ABI, bound with ctypes
// by gta_tpu_torch/data/native.py, built with g++ against zlib (no libpng).
//
// The port's counterpart of csrc/image_decode.cpp, which decodes through
// libpng. It decodes what gta_tpu_torch/data/png.py decodes and returns the
// same arrays: colour types 0, 2, 3, 4 and 6 at bit depth 8, not
// interlaced, every scanline filter, the image data over any number of IDAT
// chunks, every chunk's CRC checked; a palette expanded through PLTE (tRNS
// ignored, indices past the palette black), as imageio does. Each file gets
// a status (0, or a code that gta_png_error names); a file that fails leaves
// its output slot untouched. The files of one call decode in parallel
// threads, each file whole in one thread.

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

enum Status : int {
  kOk = 0,
  kOpen,
  kSignature,
  kTruncated,
  kCrc,
  kIhdr,
  kInterlace,
  kDepth,
  kColour,
  kMethod,
  kNoPlte,
  kNoIdat,
  kZlib,
  kDataSize,
  kFilter,
  kChunk,
  kSize,
  kChannels,
  kCount,
};

const char* const kMessages[kCount] = {
    "ok",
    "cannot open or read the file",
    "not a PNG file",
    "truncated PNG",
    "bad CRC in a chunk",
    "no IHDR chunk, or one of the wrong length",
    "Adam7-interlaced PNGs are not supported",
    "bit depth is not supported (8 only)",
    "colour type is not a PNG colour type",
    "unknown compression or filter method",
    "palette image without a PLTE chunk",
    "no IDAT chunk",
    "corrupt image data (zlib)",
    "image data holds another number of bytes than the header gives",
    "unknown scanline filter type",
    "malformed PLTE or tEXt chunk",
    "image of another size than expected",
    "image of another colour type than expected",
};

const uint8_t kSignatureBytes[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 | p[3];
}

// samples per pixel of each colour type; 0 where the type is not a PNG one
inline int samples(int colour) {
  switch (colour) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
    default: return 0;
  }
}

// channels of the array imageio returns: gray [h, w] (1), gray + alpha 2,
// RGB and palette 3, RGBA 4
inline int out_channels(int colour) { return colour == 3 ? 3 : samples(colour); }

struct Png {
  uint32_t w = 0, h = 0;
  int colour = -1;
  bool has_header = false;
  uint8_t palette[256 * 3] = {};  // indices past the palette read black
  bool has_palette = false;
  std::vector<std::pair<size_t, size_t>> idat;  // (offset, length) in the file
};

bool read_file(const char* path, std::vector<uint8_t>& data) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  bool ok = std::fseek(f, 0, SEEK_END) == 0;
  const long size = ok ? std::ftell(f) : -1;
  ok = size >= 0 && std::fseek(f, 0, SEEK_SET) == 0;
  if (ok) {
    data.resize((size_t)size);
    ok = std::fread(data.data(), 1, data.size(), f) == data.size();
  }
  std::fclose(f);
  return ok;
}

// Walk the chunks up to IEND (each CRC checked) and validate the header in
// data/png.py's order; with header_only, stop at the first IHDR.
int parse(const std::vector<uint8_t>& data, Png& png, bool header_only) {
  const uint8_t* d = data.data();
  const size_t size = data.size();
  if (size < 8 || std::memcmp(d, kSignatureBytes, 8) != 0) return kSignature;
  size_t pos = 8;
  bool methods_ok = true, interlaced = false;
  int depth = 0;
  for (;;) {
    if (pos + 8 > size) return kTruncated;
    const uint64_t n = be32(d + pos);
    const uint8_t* kind = d + pos + 4;
    const uint64_t end = pos + 12 + n;
    if (end > size) return kTruncated;
    if ((uint32_t)crc32(0L, kind, (uInt)(n + 4)) != be32(d + end - 4)) return kCrc;
    const uint8_t* body = kind + 4;
    if (std::memcmp(kind, "IHDR", 4) == 0) {
      if (n != 13) return kIhdr;
      png.has_header = true;
      png.w = be32(body);
      png.h = be32(body + 4);
      depth = body[8];
      png.colour = body[9];
      methods_ok = body[10] == 0 && body[11] == 0;
      interlaced = body[12] != 0;
      if (header_only) break;
    } else if (std::memcmp(kind, "PLTE", 4) == 0) {
      if (n % 3) return kChunk;
      std::memset(png.palette, 0, sizeof(png.palette));
      std::memcpy(png.palette, body, std::min<size_t>(n, sizeof(png.palette)));
      png.has_palette = true;
    } else if (std::memcmp(kind, "IDAT", 4) == 0) {
      png.idat.emplace_back(pos + 8, (size_t)n);
    } else if (std::memcmp(kind, "tEXt", 4) == 0) {
      if (std::memchr(body, 0, n) == nullptr) return kChunk;  // no key/value separator
    } else if (std::memcmp(kind, "IEND", 4) == 0) {
      break;
    }
    pos = end;
  }
  if (!png.has_header) return kIhdr;
  if (interlaced) return kInterlace;
  if (depth != 8) return kDepth;
  if (samples(png.colour) == 0) return kColour;
  if (!methods_ok) return kMethod;
  if (header_only) return kOk;
  if (png.colour == 3 && !png.has_palette) return kNoPlte;
  if (png.idat.empty()) return kNoIdat;
  return kOk;
}

// Inflate the IDAT chunks into raw ([h, 1 + stride] filtered scanlines).
// As Python's zlib.decompress, bytes after the end of the stream are
// ignored.
int inflate_idat(const std::vector<uint8_t>& data, const Png& png, std::vector<uint8_t>& raw) {
  const size_t stride = (size_t)png.w * samples(png.colour);
  const size_t want = (size_t)png.h * (stride + 1);
  raw.resize(want + 1);  // one byte more shows a stream that holds too much
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return kZlib;
  zs.next_out = raw.data();
  zs.avail_out = (uInt)raw.size();
  int ret = Z_OK;
  for (const auto& span : png.idat) {
    zs.next_in = const_cast<Bytef*>(data.data() + span.first);
    zs.avail_in = (uInt)span.second;
    while (zs.avail_in > 0 && zs.avail_out > 0) {
      ret = inflate(&zs, Z_NO_FLUSH);
      if (ret == Z_STREAM_END) break;
      if (ret != Z_OK) {
        inflateEnd(&zs);
        return kZlib;
      }
    }
    if (ret == Z_STREAM_END || zs.avail_out == 0) break;
  }
  const size_t produced = raw.size() - zs.avail_out;
  inflateEnd(&zs);
  if (zs.avail_out == 0) return kDataSize;
  if (ret != Z_STREAM_END) return kZlib;
  return produced == want ? kOk : kDataSize;
}

inline uint8_t paeth(int a, int b, int c) {
  const int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
  return (uint8_t)((pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c));
}

// Undo the scanline filters in place: raw is [h, 1 + stride], each row's
// first byte its filter type.
int unfilter(std::vector<uint8_t>& raw, size_t h, size_t stride, int bpp) {
  std::vector<uint8_t> zero(stride, 0);
  const uint8_t* prior = zero.data();
  for (size_t y = 0; y < h; ++y) {
    uint8_t* row = raw.data() + y * (stride + 1);
    uint8_t* x = row + 1;
    switch (row[0]) {
      case 0:
        break;
      case 1:
        for (size_t i = bpp; i < stride; ++i) x[i] = (uint8_t)(x[i] + x[i - bpp]);
        break;
      case 2:
        for (size_t i = 0; i < stride; ++i) x[i] = (uint8_t)(x[i] + prior[i]);
        break;
      case 3:
        for (size_t i = 0; i < (size_t)bpp && i < stride; ++i) x[i] = (uint8_t)(x[i] + (prior[i] >> 1));
        for (size_t i = bpp; i < stride; ++i) x[i] = (uint8_t)(x[i] + ((x[i - bpp] + prior[i]) >> 1));
        break;
      case 4:
        for (size_t i = 0; i < (size_t)bpp && i < stride; ++i) x[i] = (uint8_t)(x[i] + paeth(0, prior[i], 0));
        for (size_t i = bpp; i < stride; ++i)
          x[i] = (uint8_t)(x[i] + paeth(x[i - bpp], prior[i], prior[i - bpp]));
        break;
      default:
        return kFilter;
    }
    prior = x;
  }
  return kOk;
}

// Decode the file at path, of size h x w, into the filtered-then-undone
// scanlines in raw; png gets its header and palette.
int decode(const char* path, int h, int w, std::vector<uint8_t>& data, std::vector<uint8_t>& raw, Png& png) {
  if (!read_file(path, data)) return kOpen;
  int st = parse(data, png, false);
  if (st != kOk) return st;
  if (png.h != (uint32_t)h || png.w != (uint32_t)w) return kSize;
  st = inflate_idat(data, png, raw);
  if (st != kOk) return st;
  return unfilter(raw, png.h, (size_t)png.w * samples(png.colour), samples(png.colour));
}

// Per-thread scratch: the file's bytes and its inflated scanlines.
struct Scratch {
  std::vector<uint8_t> data, raw;
};

template <typename Fn>
int parallel_for(int n, int threads, int* status, Fn fn) {
  std::atomic<int> next(0), failures(0);
  auto worker = [&] {
    Scratch scratch;
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      status[i] = fn(i, scratch);
      if (status[i] != kOk) failures.fetch_add(1);
    }
  };
  int nt = threads > 0 ? threads : (int)std::thread::hardware_concurrency();
  if (nt > n) nt = n;
  if (nt <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(nt);
    for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failures.load();
}

// Row y's samples, expanded as imageio expands them, into dst (c channels a
// pixel, c = out_channels(colour)).
inline void expand_row(const Png& png, const uint8_t* x, uint8_t* dst) {
  const size_t w = png.w;
  if (png.colour == 3) {
    for (size_t i = 0; i < w; ++i) std::memcpy(dst + 3 * i, png.palette + 3 * x[i], 3);
  } else {
    std::memcpy(dst, x, w * samples(png.colour));
  }
}

}  // namespace

extern "C" {

// What a status code means.
const char* gta_png_error(int status) {
  return status >= 0 && status < kCount ? kMessages[status] : "unknown status";
}

// The size and the channels of the array the file decodes to (1 for gray,
// which decodes to [h, w]); the status.
int gta_png_header(const char* path, int* h, int* w, int* channels) {
  std::vector<uint8_t> data;
  if (!read_file(path, data)) return kOpen;
  Png png;
  const int st = parse(data, png, true);
  if (st != kOk) return st;
  *h = (int)png.h;
  *w = (int)png.w;
  *channels = out_channels(png.colour);
  return kOk;
}

// Decode n PNGs of size h x w whose arrays have c channels into out
// [n, h, w, c] uint8, as imageio.v2.imread returns them. status[i] gets
// file i's status; returns the number of files that failed.
int gta_decode_pngs_u8(const char** paths, int n, int h, int w, int c, int threads, uint8_t* out,
                       int* status) {
  const size_t slot = (size_t)h * w * c;
  return parallel_for(n, threads, status, [&](int i, Scratch& s) {
    Png png;
    int st = decode(paths[i], h, w, s.data, s.raw, png);
    if (st != kOk) return st;
    if (out_channels(png.colour) != c) return (int)kChannels;
    const size_t stride = (size_t)w * samples(png.colour);
    uint8_t* dst = out + (size_t)i * slot;
    for (int y = 0; y < h; ++y) expand_row(png, s.raw.data() + y * (stride + 1) + 1, dst + (size_t)y * w * c);
    return (int)kOk;
  });
}

// Decode n RGB, RGBA or palette PNGs of size h x w into out [n, h, w, 3]
// float32, x / 255 of the first three channels (the division the readers
// make, not a multiply by 1/255, which differs in the last bit at 126 of
// the 256 byte values).
int gta_decode_pngs_rgb(const char** paths, int n, int h, int w, int threads, float* out, int* status) {
  float scale[256];
  for (int x = 0; x < 256; ++x) scale[x] = (float)x / 255.0f;
  const size_t slot = (size_t)h * w * 3;
  return parallel_for(n, threads, status, [&](int i, Scratch& s) {
    Png png;
    int st = decode(paths[i], h, w, s.data, s.raw, png);
    if (st != kOk) return st;
    const int c = out_channels(png.colour);
    if (c < 3) return (int)kChannels;
    const size_t stride = (size_t)w * samples(png.colour);
    std::vector<uint8_t> row((size_t)w * c);
    float* dst = out + (size_t)i * slot;
    for (int y = 0; y < h; ++y) {
      expand_row(png, s.raw.data() + y * (stride + 1) + 1, row.data());
      for (int x = 0; x < w; ++x)
        for (int k = 0; k < 3; ++k) *dst++ = scale[row[(size_t)x * c + k]];
    }
    return (int)kOk;
  });
}

// Decode n gray PNGs (colour type 0: CLEVR-TR's entity-index masks) of size
// h x w into out [n, h, w] uint8.
int gta_decode_pngs_gray(const char** paths, int n, int h, int w, int threads, uint8_t* out, int* status) {
  return gta_decode_pngs_u8(paths, n, h, w, 1, threads, out, status);
}

}  // extern "C"
