// SE3DS native data loader (the port's copy of native/dataloader.cc).
//
// Performs the host-side hot path of the input pipeline in C++ with the
// GIL released: TFRecord framing + crc32c, tf.train.Example wire-format
// walking, and PNG decode (zlib inflate + scanline unfiltering, 8-bit
// RGB/gray and 16-bit gray). One call decodes a full image-pair record
// (the R2RImageDataset schema, reference datasets/indoor_datasets.py:
// 149-247) directly into caller-provided numpy buffers.
//
// Exposed as a plain C ABI for ctypes (se3ds_torch/data/native_loader.py,
// which builds it with g++ -O3 -shared -fPIC -std=c++17 ... -lz into
// build/se3ds_torch/ at first use).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

// ---------------------------------------------------------------------------
// crc32c (Castagnoli): the SSE4.2 instruction, else a software table.
// ---------------------------------------------------------------------------

uint32_t g_crc_table[256];
bool g_crc_init = false;

void InitCrcTable() {
  const uint32_t poly = 0x82F63B78u;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = i;
    for (int k = 0; k < 8; ++k) {
      crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
    }
    g_crc_table[i] = crc;
  }
  g_crc_init = true;
}

#if defined(__x86_64__)
// The SSE4.2 crc32 instruction computes the same polynomial 8 bytes at a
// time (a checkpoint bundle's gigabytes are checked through here).
__attribute__((target("sse4.2")))
uint32_t Crc32cSse42(const uint8_t* data, size_t n) {
  uint64_t crc = 0xFFFFFFFFu;
  for (; n >= 8; n -= 8, data += 8) {
    uint64_t word;
    std::memcpy(&word, data, 8);
    crc = __builtin_ia32_crc32di(crc, word);
  }
  uint32_t c = static_cast<uint32_t>(crc);
  for (; n > 0; --n, ++data) c = __builtin_ia32_crc32qi(c, *data);
  return c ^ 0xFFFFFFFFu;
}
#endif

uint32_t Crc32c(const uint8_t* data, size_t n) {
#if defined(__x86_64__)
  static const bool sse42 = __builtin_cpu_supports("sse4.2");
  if (sse42) return Crc32cSse42(data, n);
#endif
  if (!g_crc_init) InitCrcTable();
  uint32_t crc = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) {
    crc = g_crc_table[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  }
  return crc ^ 0xFFFFFFFFu;
}

uint32_t MaskedCrc32c(const uint8_t* data, size_t n) {
  uint32_t crc = Crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

// ---------------------------------------------------------------------------
// protobuf wire-format walking.
// ---------------------------------------------------------------------------

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
};

bool ReadVarint(Cursor* c, uint64_t* out) {
  uint64_t result = 0;
  int shift = 0;
  while (c->p < c->end) {
    uint8_t b = *c->p++;
    result |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = result;
      return true;
    }
    shift += 7;
    if (shift > 63) return false;
  }
  return false;
}

struct Field {
  uint64_t number;
  int wire;
  const uint8_t* data;  // for wire 2
  size_t len;
  uint64_t varint;  // for wire 0
};

bool NextField(Cursor* c, Field* f) {
  if (c->p >= c->end) return false;
  uint64_t tag;
  if (!ReadVarint(c, &tag)) return false;
  f->number = tag >> 3;
  f->wire = static_cast<int>(tag & 7);
  switch (f->wire) {
    case 0:
      return ReadVarint(c, &f->varint);
    case 2: {
      uint64_t len;
      if (!ReadVarint(c, &len)) return false;
      if (c->p + len > c->end) return false;
      f->data = c->p;
      f->len = static_cast<size_t>(len);
      c->p += len;
      return true;
    }
    case 5:
      if (c->p + 4 > c->end) return false;
      f->data = c->p;
      f->len = 4;
      c->p += 4;
      return true;
    case 1:
      if (c->p + 8 > c->end) return false;
      f->data = c->p;
      f->len = 8;
      c->p += 8;
      return true;
    default:
      return false;
  }
}

// Feature payload: returns the first BytesList entry / FloatList values /
// Int64List values.
struct FeatureValue {
  const uint8_t* bytes = nullptr;
  size_t bytes_len = 0;
  std::vector<float> floats;
  std::vector<int64_t> ints;
};

bool ParseFeature(const uint8_t* data, size_t len, FeatureValue* out) {
  Cursor c{data, data + len};
  Field f;
  while (NextField(&c, &f)) {
    if (f.wire != 2) continue;
    Cursor inner{f.data, f.data + f.len};
    Field g;
    if (f.number == 1) {  // BytesList
      while (NextField(&inner, &g)) {
        if (g.number == 1 && g.wire == 2) {
          out->bytes = g.data;
          out->bytes_len = g.len;
          return true;
        }
      }
    } else if (f.number == 2) {  // FloatList
      while (NextField(&inner, &g)) {
        if (g.number == 1 && g.wire == 2) {  // packed
          for (size_t i = 0; i + 4 <= g.len; i += 4) {
            float v;
            memcpy(&v, g.data + i, 4);
            out->floats.push_back(v);
          }
        } else if (g.number == 1 && g.wire == 5) {
          float v;
          memcpy(&v, g.data, 4);
          out->floats.push_back(v);
        }
      }
      return true;
    } else if (f.number == 3) {  // Int64List
      while (NextField(&inner, &g)) {
        if (g.number == 1 && g.wire == 2) {  // packed varints
          Cursor pc{g.data, g.data + g.len};
          uint64_t v;
          while (ReadVarint(&pc, &v)) {
            out->ints.push_back(static_cast<int64_t>(v));
          }
        } else if (g.number == 1 && g.wire == 0) {
          out->ints.push_back(static_cast<int64_t>(g.varint));
        }
      }
      return true;
    }
  }
  return out->bytes != nullptr || !out->floats.empty() || !out->ints.empty();
}

// Finds a feature by key inside an Example message.
bool FindFeature(const uint8_t* example, size_t len, const char* key,
                 FeatureValue* out) {
  size_t key_len = strlen(key);
  Cursor c{example, example + len};
  Field f;
  while (NextField(&c, &f)) {
    if (f.number != 1 || f.wire != 2) continue;  // Features
    Cursor feats{f.data, f.data + f.len};
    Field entry;
    while (NextField(&feats, &entry)) {
      if (entry.number != 1 || entry.wire != 2) continue;  // map entry
      Cursor e{entry.data, entry.data + entry.len};
      Field kv;
      const uint8_t* k = nullptr;
      size_t klen = 0;
      const uint8_t* v = nullptr;
      size_t vlen = 0;
      while (NextField(&e, &kv)) {
        if (kv.number == 1 && kv.wire == 2) {
          k = kv.data;
          klen = kv.len;
        } else if (kv.number == 2 && kv.wire == 2) {
          v = kv.data;
          vlen = kv.len;
        }
      }
      if (k && v && klen == key_len && memcmp(k, key, key_len) == 0) {
        return ParseFeature(v, vlen, out);
      }
    }
  }
  return false;
}

// ---------------------------------------------------------------------------
// PNG decode (no interlace; 8-bit gray/RGB/RGBA, 16-bit gray).
// ---------------------------------------------------------------------------

uint32_t ReadBE32(const uint8_t* p) {
  return (static_cast<uint32_t>(p[0]) << 24) | (p[1] << 16) | (p[2] << 8) |
         p[3];
}

struct PngInfo {
  uint32_t width = 0, height = 0;
  int bit_depth = 0, color_type = 0, channels = 0;
};

int PaethPredictor(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Decodes into out (row-major, big-endian for 16-bit as in PNG).
// Returns 0 on success.
int DecodePng(const uint8_t* data, size_t len, PngInfo* info, uint8_t* out,
              size_t out_capacity) {
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  if (len < 8 || memcmp(data, sig, 8) != 0) return -1;
  size_t pos = 8;
  std::vector<uint8_t> idat;
  while (pos + 12 <= len) {
    uint32_t chunk_len = ReadBE32(data + pos);
    const uint8_t* tag = data + pos + 4;
    const uint8_t* payload = data + pos + 8;
    if (pos + 12 + chunk_len > len) return -2;
    if (memcmp(tag, "IHDR", 4) == 0) {
      info->width = ReadBE32(payload);
      info->height = ReadBE32(payload + 4);
      info->bit_depth = payload[8];
      info->color_type = payload[9];
      if (payload[12] != 0) return -3;  // interlaced unsupported
      switch (info->color_type) {
        case 0: info->channels = 1; break;
        case 2: info->channels = 3; break;
        case 4: info->channels = 2; break;
        case 6: info->channels = 4; break;
        default: return -4;
      }
      // Header-only query: skip the IDAT accumulation (it copies the
      // whole compressed stream, ~MBs per pano).
      if (out == nullptr) return 0;
    } else if (memcmp(tag, "IDAT", 4) == 0) {
      idat.insert(idat.end(), payload, payload + chunk_len);
    } else if (memcmp(tag, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + chunk_len;
  }
  if (info->width == 0 || idat.empty()) return -5;
  size_t bpp = info->channels * (info->bit_depth / 8);
  size_t stride = info->width * bpp;
  size_t raw_size = info->height * (stride + 1);
  if (out_capacity < info->height * stride) return -6;

  // new[] (not std::vector) so the multi-MB scratch is NOT zero-filled
  // before uncompress overwrites every byte.
  std::unique_ptr<uint8_t[]> raw(new uint8_t[raw_size]);
  uLongf dest_len = raw_size;
  if (uncompress(raw.get(), &dest_len, idat.data(), idat.size()) != Z_OK ||
      dest_len != raw_size) {
    return -7;
  }
  // The previous row is read straight from `out` (a zero row for y = 0)
  // — no per-row copy. The first `bpp` bytes of each filtered row have
  // no left neighbour (a = c = 0), so each filter peels them off and
  // the hot loop runs branch-free.
  std::vector<uint8_t> zero_row(stride, 0);
  const uint8_t* prev = zero_row.data();
  for (uint32_t y = 0; y < info->height; ++y) {
    uint8_t filter = raw[y * (stride + 1)];
    const uint8_t* line = raw.get() + y * (stride + 1) + 1;
    uint8_t* cur = out + y * stride;
    size_t head = stride < bpp ? stride : bpp;
    switch (filter) {
      case 0:
        memcpy(cur, line, stride);
        break;
      case 1:
        memcpy(cur, line, head);
        for (size_t x = head; x < stride; ++x) {
          cur[x] = static_cast<uint8_t>(line[x] + cur[x - bpp]);
        }
        break;
      case 2:
        for (size_t x = 0; x < stride; ++x) {
          cur[x] = static_cast<uint8_t>(line[x] + prev[x]);
        }
        break;
      case 3:
        for (size_t x = 0; x < head; ++x) {
          cur[x] = static_cast<uint8_t>(line[x] + (prev[x] >> 1));
        }
        for (size_t x = head; x < stride; ++x) {
          cur[x] = static_cast<uint8_t>(
              line[x] + ((cur[x - bpp] + prev[x]) >> 1));
        }
        break;
      case 4:
        // Paeth with a = c = 0 reduces to b (= prev).
        for (size_t x = 0; x < head; ++x) {
          cur[x] = static_cast<uint8_t>(line[x] + prev[x]);
        }
        for (size_t x = head; x < stride; ++x) {
          cur[x] = static_cast<uint8_t>(
              line[x] + PaethPredictor(cur[x - bpp], prev[x],
                                       prev[x - bpp]));
        }
        break;
      default:
        return -8;
    }
    prev = cur;
  }
  return 0;
}

// Decode helper writing into typed outputs (u8 or u16 host-endian).
int DecodePngInto(const FeatureValue& fv, int expect_channels,
                  int expect_bit_depth, uint32_t expect_h, uint32_t expect_w,
                  void* out) {
  if (fv.bytes == nullptr) return -20;
  PngInfo info;
  int rc = DecodePng(fv.bytes, fv.bytes_len, &info, nullptr, 0);
  if (rc != 0) return rc;
  if (info.height != expect_h || info.width != expect_w) return -21;
  if (info.bit_depth != expect_bit_depth) return -22;
  // Allow channel mismatch 1 vs expected (e.g. grayscale stored).
  size_t bpp = info.channels * (info.bit_depth / 8);
  size_t n = info.height * info.width * bpp;
  if (info.bit_depth == 8 && info.channels == expect_channels) {
    // Common case: unfilter straight into the caller's buffer (no tmp
    // double-buffer, no copy).
    return DecodePng(fv.bytes, fv.bytes_len, &info,
                     static_cast<uint8_t*>(out), n);
  }
  if (info.bit_depth == 16) {  // PNG big-endian -> host little-endian
    if (info.channels != 1 || expect_channels != 1) return -24;
    // Decode in place, then swap each byte pair (each element reads the
    // two bytes it overwrites — elementwise safe).
    uint8_t* raw8 = static_cast<uint8_t*>(out);
    rc = DecodePng(fv.bytes, fv.bytes_len, &info, raw8, n);
    if (rc != 0) return rc;
    uint16_t* dst = static_cast<uint16_t*>(out);
    for (size_t i = 0; i < info.height * info.width; ++i) {
      dst[i] = static_cast<uint16_t>((raw8[2 * i] << 8) | raw8[2 * i + 1]);
    }
    return 0;
  }
  // Channel-count mismatch (rare): decode to scratch, then remap.
  std::unique_ptr<uint8_t[]> tmp(new uint8_t[n]);
  rc = DecodePng(fv.bytes, fv.bytes_len, &info, tmp.get(), n);
  if (rc != 0) return rc;
  uint8_t* dst = static_cast<uint8_t*>(out);
  if (info.channels == 1 && expect_channels == 3) {
    for (size_t i = 0; i < info.height * info.width; ++i) {
      dst[3 * i] = dst[3 * i + 1] = dst[3 * i + 2] = tmp[i];
    }
  } else if (expect_channels == 1) {
    for (size_t i = 0; i < info.height * info.width; ++i) {
      dst[i] = tmp[i * info.channels];
    }
  } else {
    return -23;
  }
  return 0;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// TFRecord reader handle.
struct TfrReader {
  FILE* f;
  std::vector<uint8_t> buf;
};

void* se3ds_tfr_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* r = new TfrReader();
  r->f = f;
  return r;
}

// Returns payload length (>0), 0 on EOF, <0 on error. Payload pointer is
// valid until the next call.
long long se3ds_tfr_next(void* handle, const uint8_t** data,
                         int verify_crc) {
  auto* r = static_cast<TfrReader*>(handle);
  uint8_t header[12];
  if (fread(header, 1, 12, r->f) != 12) return 0;  // EOF
  uint64_t len;
  memcpy(&len, header, 8);  // little-endian host assumed
  if (verify_crc) {
    uint32_t crc;
    memcpy(&crc, header + 8, 4);
    if (MaskedCrc32c(header, 8) != crc) return -1;
  }
  r->buf.resize(len + 4);
  if (fread(r->buf.data(), 1, len + 4, r->f) != len + 4) return -2;
  if (verify_crc) {
    uint32_t crc;
    memcpy(&crc, r->buf.data() + len, 4);
    if (MaskedCrc32c(r->buf.data(), len) != crc) return -3;
  }
  *data = r->buf.data();
  return static_cast<long long>(len);
}

void se3ds_tfr_close(void* handle) {
  auto* r = static_cast<TfrReader*>(handle);
  fclose(r->f);
  delete r;
}

uint32_t se3ds_crc32c(const uint8_t* data, size_t n) {
  return Crc32c(data, n);
}

// Decodes a full R2R image-pair Example into caller buffers.
// All image buffers must be sized for (height, width) with the channel
// counts in the signature. Returns 0 on success, negative error code
// otherwise. `has_visible` reports whether image/visible_mask existed.
int se3ds_decode_image_example(
    const uint8_t* record, size_t record_len, uint32_t height, uint32_t width,
    uint8_t* image /*H*W*3*/, uint8_t* proj_image /*H*W*3*/,
    uint16_t* depth /*H*W*/, uint16_t* proj_depth /*H*W*/,
    uint8_t* proj_mask /*H*W*/, uint8_t* blurred_mask /*H*W*/,
    uint8_t* segmentation /*H*W*/, uint8_t* visible_mask /*H*W*/,
    float* depth_scale, long long* dataset_type, float* bbox /*4*/,
    int* has_visible) {
  FeatureValue fv;
  int rc;

  fv = FeatureValue();
  if (!FindFeature(record, record_len, "image/encoded", &fv)) return -101;
  if ((rc = DecodePngInto(fv, 3, 8, height, width, image)) != 0) return rc;

  fv = FeatureValue();
  if (!FindFeature(record, record_len, "proj/encoded", &fv)) return -102;
  if ((rc = DecodePngInto(fv, 3, 8, height, width, proj_image)) != 0)
    return rc;

  fv = FeatureValue();
  if (!FindFeature(record, record_len, "image/depth", &fv)) return -103;
  if ((rc = DecodePngInto(fv, 1, 16, height, width, depth)) != 0) return rc;

  fv = FeatureValue();
  if (!FindFeature(record, record_len, "proj/depth", &fv)) return -104;
  if ((rc = DecodePngInto(fv, 1, 16, height, width, proj_depth)) != 0)
    return rc;

  fv = FeatureValue();
  if (!FindFeature(record, record_len, "proj/mask", &fv)) return -105;
  if ((rc = DecodePngInto(fv, 1, 8, height, width, proj_mask)) != 0)
    return rc;

  fv = FeatureValue();
  if (!FindFeature(record, record_len, "image/blurred_mask", &fv))
    return -106;
  if ((rc = DecodePngInto(fv, 1, 8, height, width, blurred_mask)) != 0)
    return rc;

  fv = FeatureValue();
  if (!FindFeature(record, record_len, "image/segmentation/class/encoded",
                   &fv))
    return -107;
  if ((rc = DecodePngInto(fv, 1, 8, height, width, segmentation)) != 0)
    return rc;

  *has_visible = 0;
  fv = FeatureValue();
  if (FindFeature(record, record_len, "image/visible_mask", &fv) &&
      fv.bytes != nullptr && fv.bytes_len > 0) {
    if ((rc = DecodePngInto(fv, 1, 8, height, width, visible_mask)) == 0) {
      *has_visible = 1;
    }
  }

  fv = FeatureValue();
  *depth_scale = 10.0f;
  if (FindFeature(record, record_len, "depth_scale", &fv) &&
      !fv.floats.empty()) {
    *depth_scale = fv.floats[0];
  }
  fv = FeatureValue();
  *dataset_type = 0;
  if (FindFeature(record, record_len, "dataset_type", &fv) &&
      !fv.ints.empty()) {
    *dataset_type = fv.ints[0];
  }
  fv = FeatureValue();
  bbox[0] = bbox[1] = bbox[2] = bbox[3] = 0.0f;
  if (FindFeature(record, record_len, "bbox", &fv) &&
      fv.floats.size() >= 4) {
    for (int i = 0; i < 4; ++i) bbox[i] = fv.floats[i];
  }
  return 0;
}

// Standalone PNG decode for generic use. Two-phase: call with out=NULL to
// fill info (h, w, channels, bit_depth), then with a buffer.
int se3ds_png_decode(const uint8_t* data, size_t len, uint8_t* out,
                     size_t out_capacity, uint32_t* h, uint32_t* w,
                     int* channels, int* bit_depth) {
  PngInfo info;
  int rc = DecodePng(data, len, &info, out, out_capacity);
  *h = info.height;
  *w = info.width;
  *channels = info.channels;
  *bit_depth = info.bit_depth;
  return rc;
}

}  // extern "C"
