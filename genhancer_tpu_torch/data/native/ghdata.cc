// ghdata: the native JPEG decoder of the input pipeline (the port's copy of
// genhancer_tpu/data/native/ghdata.cc; the code is the same, so both
// packages decode to the same pixels).
//
// Batched multithreaded JPEG decode + crop + area resize producing float32
// [0,1] HWC tensors.  No GIL, no per-image Python overhead: one ctypes call
// decodes a whole batch across N threads.
//
// C ABI (consumed by genhancer_tpu_torch/data/native_decode.py via ctypes):
//   ghd_get_dims     — parse JPEG headers for (w, h) without full decode
//   ghd_decode_batch — decode; per-image crop rect in source pixel coords
//                      (x0, y0, w, h; w<=0 means full image), resize to
//                      (size, size), normalize to [0,1].
//
// Built at first use by core/kernels/_build.py (a host C++ compiler, links
// -ljpeg) into a git-ignored directory.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode one JPEG into an RGB8 buffer.  Returns true on success.
bool decode_rgb(const uint8_t* data, size_t len, std::vector<uint8_t>* out,
                int* width, int* height) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width;
  const int h = cinfo.output_height;
  out->resize(static_cast<size_t>(w) * h * 3);
  JSAMPROW row;
  while (cinfo.output_scanline < cinfo.output_height) {
    row = out->data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *width = w;
  *height = h;
  return true;
}

// Area-average downsample (cv2 INTER_AREA / antialiased-resize equivalent):
// each output pixel averages its source box.  Used when downscaling —
// bilinear subsampling aliases badly at scale > ~1.3x.
void area_resize_crop(const uint8_t* src, int sw, int sh, float x0, float y0,
                      float cw, float ch, int size, float* dst) {
  const float sx = cw / size;
  const float sy = ch / size;
  for (int oy = 0; oy < size; ++oy) {
    const float fy0 = y0 + oy * sy;
    const float fy1 = fy0 + sy;
    const int iy0 = std::max(0, static_cast<int>(fy0));
    const int iy1 = std::min(sh, std::max(iy0 + 1, static_cast<int>(std::ceil(fy1))));
    for (int ox = 0; ox < size; ++ox) {
      const float fx0 = x0 + ox * sx;
      const float fx1 = fx0 + sx;
      const int ix0 = std::max(0, static_cast<int>(fx0));
      const int ix1 = std::min(sw, std::max(ix0 + 1, static_cast<int>(std::ceil(fx1))));
      float acc[3] = {0, 0, 0};
      float wsum = 0;
      for (int y = iy0; y < iy1; ++y) {
        const float wy = std::min(fy1, static_cast<float>(y + 1)) -
                         std::max(fy0, static_cast<float>(y));
        for (int x = ix0; x < ix1; ++x) {
          const float wx = std::min(fx1, static_cast<float>(x + 1)) -
                           std::max(fx0, static_cast<float>(x));
          const float w2 = wx * wy;
          const uint8_t* p = src + (static_cast<size_t>(y) * sw + x) * 3;
          acc[0] += p[0] * w2;
          acc[1] += p[1] * w2;
          acc[2] += p[2] * w2;
          wsum += w2;
        }
      }
      float* o = dst + (static_cast<size_t>(oy) * size + ox) * 3;
      const float inv = wsum > 0 ? 1.0f / (wsum * 255.0f) : 0.0f;
      o[0] = acc[0] * inv;
      o[1] = acc[1] * inv;
      o[2] = acc[2] * inv;
    }
  }
}

// Bilinear sample from an RGB8 image region into float32 [0,1] (size x size).
void resize_crop(const uint8_t* src, int sw, int sh, float x0, float y0,
                 float cw, float ch, int size, float* dst) {
  const float sx = cw / size;
  const float sy = ch / size;
  if (sx > 1.3f || sy > 1.3f) {  // downscale -> antialiased area average
    area_resize_crop(src, sw, sh, x0, y0, cw, ch, size, dst);
    return;
  }
  for (int oy = 0; oy < size; ++oy) {
    // align_corners=False convention (matches PIL box resize closely)
    float fy = y0 + (oy + 0.5f) * sy - 0.5f;
    fy = std::min(std::max(fy, 0.0f), static_cast<float>(sh - 1));
    const int y1 = static_cast<int>(fy);
    const int y2 = std::min(y1 + 1, sh - 1);
    const float wy = fy - y1;
    for (int ox = 0; ox < size; ++ox) {
      float fx = x0 + (ox + 0.5f) * sx - 0.5f;
      fx = std::min(std::max(fx, 0.0f), static_cast<float>(sw - 1));
      const int x1 = static_cast<int>(fx);
      const int x2 = std::min(x1 + 1, sw - 1);
      const float wx = fx - x1;
      const uint8_t* p11 = src + (static_cast<size_t>(y1) * sw + x1) * 3;
      const uint8_t* p12 = src + (static_cast<size_t>(y1) * sw + x2) * 3;
      const uint8_t* p21 = src + (static_cast<size_t>(y2) * sw + x1) * 3;
      const uint8_t* p22 = src + (static_cast<size_t>(y2) * sw + x2) * 3;
      float* o = dst + (static_cast<size_t>(oy) * size + ox) * 3;
      for (int c = 0; c < 3; ++c) {
        const float top = p11[c] * (1 - wx) + p12[c] * wx;
        const float bot = p21[c] * (1 - wx) + p22[c] * wx;
        o[c] = (top * (1 - wy) + bot * wy) * (1.0f / 255.0f);
      }
    }
  }
}

}  // namespace

extern "C" {

// Parse JPEG headers only. dims_out: [n*2] as (w, h) pairs; 0,0 on failure.
void ghd_get_dims(const uint8_t** data, const size_t* lens, int n,
                  int* dims_out) {
  for (int i = 0; i < n; ++i) {
    jpeg_decompress_struct cinfo;
    ErrMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = error_exit;
    dims_out[2 * i] = dims_out[2 * i + 1] = 0;
    if (setjmp(jerr.jump)) {
      jpeg_destroy_decompress(&cinfo);
      continue;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data[i]),
                 static_cast<unsigned long>(lens[i]));
    if (jpeg_read_header(&cinfo, TRUE) == JPEG_HEADER_OK) {
      dims_out[2 * i] = cinfo.image_width;
      dims_out[2 * i + 1] = cinfo.image_height;
    }
    jpeg_destroy_decompress(&cinfo);
  }
}

// Decode n JPEGs with per-image crop rects (source coords; w<=0 -> full
// image) into out [n, size, size, 3] float32 [0,1].  ok_out[i] = 1/0.
// Work is split across num_threads OS threads (no GIL involvement).
void ghd_decode_batch(const uint8_t** data, const size_t* lens, int n,
                      const float* rects, int size, int num_threads,
                      float* out, uint8_t* ok_out) {
  std::atomic<int> next(0);
  auto worker = [&]() {
    std::vector<uint8_t> rgb;
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      int w = 0, h = 0;
      ok_out[i] = 0;
      if (!decode_rgb(data[i], lens[i], &rgb, &w, &h) || w == 0 || h == 0) {
        std::memset(out + static_cast<size_t>(i) * size * size * 3, 0,
                    sizeof(float) * size * size * 3);
        continue;
      }
      float x0 = rects[4 * i], y0 = rects[4 * i + 1];
      float cw = rects[4 * i + 2], chh = rects[4 * i + 3];
      if (cw <= 0 || chh <= 0) {
        x0 = 0; y0 = 0; cw = static_cast<float>(w); chh = static_cast<float>(h);
      }
      resize_crop(rgb.data(), w, h, x0, y0, cw, chh, size,
                  out + static_cast<size_t>(i) * size * size * 3);
      ok_out[i] = 1;
    }
  };
  const int t = std::max(1, std::min(num_threads, n));
  std::vector<std::thread> threads;
  threads.reserve(t);
  for (int k = 0; k < t; ++k) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

}  // extern "C"
