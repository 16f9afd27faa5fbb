// Native language-feature loader of langsplat_tpu_torch (host C++, no device code).
//
// Phase B of training reads, for every view, `<image>_s.npy` (segment maps,
// [4,H,W] int) and `<image>_f.npy` (per-segment codes, [M,F] float16 or float32) and
// gathers a per-pixel feature image. The numpy path makes three temporaries ([H,W,F]
// gather, masked where, CHW transpose copy) on one thread. This library does the whole
// contract in one multithreaded pass over the mmapped inputs: npy header parse, then
// per pixel {mask = seg != -1, idx = clamp(seg, 0, M-1), float16 -> float32, masked
// write} straight into the planar [F,H,W] output.
//
// C ABI, bound with ctypes by native/__init__.py:
//   ls_gather_feature(seg_path, feat_path, level, H, W, F, out_feature, out_mask,
//                     num_threads) -> 0 on success, a negative error code otherwise
//   ls_npy_shape(path, out_shape[8], out_ndim) -> dtype code (kind << 8 | itemsize)
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread (native/__init__.py).

#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

enum ErrorCode {
  LS_OK = 0,
  LS_ERR_OPEN = -1,
  LS_ERR_PARSE = -2,
  LS_ERR_DTYPE = -3,
  LS_ERR_SHAPE = -4,
  LS_ERR_LEVEL = -5,
};

struct NpyView {
  const uint8_t* base = nullptr;  // mmap base (for munmap)
  size_t map_len = 0;
  const uint8_t* data = nullptr;  // first element
  std::vector<int64_t> shape;
  char kind = 0;      // 'i' int, 'u' uint, 'f' float
  int itemsize = 0;
  bool fortran = false;

  ~NpyView() {
    if (base != nullptr) munmap(const_cast<uint8_t*>(base), map_len);
  }
  NpyView() = default;
  NpyView(const NpyView&) = delete;
  NpyView& operator=(const NpyView&) = delete;
};

// Minimal strict parser for the npy v1/v2/v3 header written by numpy.save.
int open_npy(const char* path, NpyView* out) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return LS_ERR_OPEN;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 12) {
    close(fd);
    return LS_ERR_OPEN;
  }
  size_t len = static_cast<size_t>(st.st_size);
  void* mem = mmap(nullptr, len, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return LS_ERR_OPEN;
  out->base = static_cast<const uint8_t*>(mem);
  out->map_len = len;

  const uint8_t* p = out->base;
  if (memcmp(p, "\x93NUMPY", 6) != 0) return LS_ERR_PARSE;
  int major = p[6];
  size_t header_len, header_off;
  if (major == 1) {
    if (len < 10) return LS_ERR_PARSE;
    header_len = static_cast<size_t>(p[8]) | (static_cast<size_t>(p[9]) << 8);
    header_off = 10;
  } else if (major == 2 || major == 3) {
    if (len < 12) return LS_ERR_PARSE;
    header_len = static_cast<size_t>(p[8]) | (static_cast<size_t>(p[9]) << 8) |
                 (static_cast<size_t>(p[10]) << 16) |
                 (static_cast<size_t>(p[11]) << 24);
    header_off = 12;
  } else {
    return LS_ERR_PARSE;
  }
  if (header_off + header_len > len) return LS_ERR_PARSE;
  std::string header(reinterpret_cast<const char*>(p + header_off), header_len);

  // descr: '<i4' / '|i1' / '<f2' ...
  size_t d = header.find("'descr'");
  if (d == std::string::npos) return LS_ERR_PARSE;
  size_t q1 = header.find('\'', d + 7);
  if (q1 == std::string::npos) return LS_ERR_PARSE;
  size_t q2 = header.find('\'', q1 + 1);
  if (q2 == std::string::npos || q2 - q1 < 3) return LS_ERR_PARSE;
  std::string descr = header.substr(q1 + 1, q2 - q1 - 1);
  char byteorder = descr[0];
  if (byteorder == '>') return LS_ERR_DTYPE;  // big-endian unsupported
  out->kind = descr[1];
  out->itemsize = atoi(descr.c_str() + 2);
  if (out->itemsize <= 0 || out->itemsize > 8) return LS_ERR_DTYPE;

  size_t f = header.find("'fortran_order'");
  if (f == std::string::npos) return LS_ERR_PARSE;
  out->fortran = header.find("True", f) != std::string::npos &&
                 header.find("True", f) < header.find(',', f);

  size_t s = header.find("'shape'");
  if (s == std::string::npos) return LS_ERR_PARSE;
  size_t po = header.find('(', s);
  size_t pc = header.find(')', po);
  if (po == std::string::npos || pc == std::string::npos) return LS_ERR_PARSE;
  std::string dims = header.substr(po + 1, pc - po - 1);
  size_t pos = 0;
  int64_t total = 1;
  while (pos < dims.size()) {
    while (pos < dims.size() && (dims[pos] == ' ' || dims[pos] == ',')) ++pos;
    if (pos >= dims.size()) break;
    int64_t v = 0;
    bool any = false;
    while (pos < dims.size() && dims[pos] >= '0' && dims[pos] <= '9') {
      v = v * 10 + (dims[pos] - '0');
      ++pos;
      any = true;
    }
    if (!any) return LS_ERR_PARSE;
    out->shape.push_back(v);
    total *= v;
  }
  if (header_off + header_len +
          static_cast<size_t>(total) * out->itemsize > len)
    return LS_ERR_PARSE;
  out->data = p + header_off + header_len;
  return LS_OK;
}

inline float half_to_float(uint16_t h) {
  uint32_t sign = static_cast<uint32_t>(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t man = h & 0x3FF;
  uint32_t bits;
  if (exp == 0) {
    if (man == 0) {
      bits = sign;
    } else {  // subnormal half -> normal float
      uint32_t e = 127 - 15 + 1;
      while (!(man & 0x400)) {
        man <<= 1;
        --e;
      }
      man &= 0x3FF;
      bits = sign | (e << 23) | (man << 13);
    }
  } else if (exp == 31) {  // inf / nan
    bits = sign | 0x7F800000u | (man << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float f;
  memcpy(&f, &bits, 4);
  return f;
}

template <typename SegT>
inline int64_t seg_at(const uint8_t* seg, int64_t idx) {
  SegT v;
  memcpy(&v, seg + idx * sizeof(SegT), sizeof(SegT));
  return static_cast<int64_t>(v);
}

// One worker: rows [y0, y1) of the fused gather.
template <typename SegT, bool kHalf>
void gather_rows(const uint8_t* seg, const uint8_t* feat, int64_t M, int64_t F,
                 int64_t H, int64_t W, int64_t y0, int64_t y1,
                 float* out_feature, float* out_mask) {
  const int64_t plane = H * W;
  for (int64_t y = y0; y < y1; ++y) {
    for (int64_t x = 0; x < W; ++x) {
      const int64_t pix = y * W + x;
      const int64_t s = seg_at<SegT>(seg, pix);
      const bool valid = s != -1;
      int64_t idx = s < 0 ? 0 : (s >= M ? M - 1 : s);
      out_mask[pix] = valid ? 1.0f : 0.0f;
      if (valid) {
        const uint8_t* row = feat + idx * F * (kHalf ? 2 : 4);
        for (int64_t f = 0; f < F; ++f) {
          float v;
          if (kHalf) {
            uint16_t hv;
            memcpy(&hv, row + f * 2, 2);
            v = half_to_float(hv);
          } else {
            memcpy(&v, row + f * 4, 4);
          }
          out_feature[f * plane + pix] = v;
        }
      } else {
        for (int64_t f = 0; f < F; ++f) out_feature[f * plane + pix] = 0.0f;
      }
    }
  }
}

template <typename SegT>
int run_gather(const NpyView& seg, const NpyView& feat, int level, int64_t H,
               int64_t W, int64_t F, float* out_feature, float* out_mask,
               int num_threads) {
  const int64_t M = feat.shape[0];
  const uint8_t* seg_level = seg.data + static_cast<int64_t>(level) * H * W *
                                            seg.itemsize;
  const bool half = feat.itemsize == 2;
  int nt = num_threads > 0 ? num_threads
                           : static_cast<int>(std::thread::hardware_concurrency());
  if (nt < 1) nt = 1;
  if (nt > 16) nt = 16;
  if (H < nt) nt = static_cast<int>(H);

  auto work = [&](int64_t y0, int64_t y1) {
    if (half)
      gather_rows<SegT, true>(seg_level, feat.data, M, F, H, W, y0, y1,
                              out_feature, out_mask);
    else
      gather_rows<SegT, false>(seg_level, feat.data, M, F, H, W, y0, y1,
                               out_feature, out_mask);
  };
  if (nt == 1) {
    work(0, H);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(nt);
    const int64_t rows = (H + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
      int64_t y0 = t * rows;
      int64_t y1 = y0 + rows > H ? H : y0 + rows;
      if (y0 >= y1) break;
      threads.emplace_back(work, y0, y1);
    }
    for (auto& th : threads) th.join();
  }
  return LS_OK;
}

}  // namespace

extern "C" {

// Fused language-feature load: seg [L,H,W] int npy + feat [M,F] f2/f4 npy ->
// out_feature [F,H,W] f32 (planar) + out_mask [H,W] f32. Exact semantics of
// Camera.get_language_feature (mask = seg != -1; index clamp to [0, M-1];
// masked-out pixels zero).
int ls_gather_feature(const char* seg_path, const char* feat_path, int level,
                      int64_t H, int64_t W, int64_t F, float* out_feature,
                      float* out_mask, int num_threads) {
  NpyView seg, feat;
  int rc = open_npy(seg_path, &seg);
  if (rc != LS_OK) return rc;
  rc = open_npy(feat_path, &feat);
  if (rc != LS_OK) return rc;

  if (seg.fortran || feat.fortran) return LS_ERR_DTYPE;
  if (seg.kind != 'i' ||
      (seg.itemsize != 2 && seg.itemsize != 4 && seg.itemsize != 8))
    return LS_ERR_DTYPE;
  if (feat.kind != 'f' || (feat.itemsize != 2 && feat.itemsize != 4))
    return LS_ERR_DTYPE;
  if (seg.shape.size() != 3 || feat.shape.size() != 2) return LS_ERR_SHAPE;
  if (level < 0 || level >= seg.shape[0]) return LS_ERR_LEVEL;
  if (seg.shape[1] != H || seg.shape[2] != W) return LS_ERR_SHAPE;
  if (feat.shape[1] != F || feat.shape[0] < 1) return LS_ERR_SHAPE;

  switch (seg.itemsize) {
    case 2:
      return run_gather<int16_t>(seg, feat, level, H, W, F, out_feature,
                                 out_mask, num_threads);
    case 4:
      return run_gather<int32_t>(seg, feat, level, H, W, F, out_feature,
                                 out_mask, num_threads);
    default:
      return run_gather<int64_t>(seg, feat, level, H, W, F, out_feature,
                                 out_mask, num_threads);
  }
}

// Probe an npy file: fills out_shape (up to 8 dims) and *out_ndim; returns the
// dtype as (kind << 8 | itemsize), or a negative error code.
int ls_npy_shape(const char* path, int64_t* out_shape, int* out_ndim) {
  NpyView v;
  int rc = open_npy(path, &v);
  if (rc != LS_OK) return rc;
  int nd = static_cast<int>(v.shape.size());
  if (nd > 8) return LS_ERR_SHAPE;
  for (int i = 0; i < nd; ++i) out_shape[i] = v.shape[i];
  *out_ndim = nd;
  return (static_cast<int>(v.kind) << 8) | v.itemsize;
}

}  // extern "C"
