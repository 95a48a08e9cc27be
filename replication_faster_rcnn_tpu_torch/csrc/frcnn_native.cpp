// Host-side kernels of the data pipeline: the fused bilinear resize +
// normalize, the same resize behind a libjpeg decode, and the box scaling
// of the VOC reader. The counterpart of the JAX package's host library; the
// CUDA kernels live beside it in csrc/*.cu.
//
// Loaded with ctypes through a plain C interface
// (data/native_ops.py builds it with g++ at first use). ctypes releases the
// interpreter lock for the length of each call, so loader threads run these
// functions in parallel.
//
// The resize is bitwise equal to its numpy specification
// (data/native_ops.py::resize_normalize_plain): it does the same float32
// operations in the same order, the sample positions in float64 as numpy
// computes them, and it must be built with -ffp-contract=off so that no
// product is fused into an add.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <vector>

#ifndef FRCNN_NO_JPEG
#include <csetjmp>

#include <jpeglib.h>
#endif

namespace {

// numpy: clip((arange(d) + 0.5) * (s / d) - 0.5, 0, s - 1) in float64, the
// integer part as the first tap, the fraction rounded to float32.
struct Taps {
  std::vector<int32_t> i0, i1;
  std::vector<float> frac;
};

Taps sample_taps(int src, int dst) {
  Taps t;
  t.i0.resize(dst);
  t.i1.resize(dst);
  t.frac.resize(dst);
  const double scale = static_cast<double>(src) / dst;
  for (int d = 0; d < dst; ++d) {
    double s = (d + 0.5) * scale - 0.5;
    s = std::min(std::max(s, 0.0), static_cast<double>(src - 1));
    const int i = static_cast<int>(s);
    t.i0[d] = i;
    t.i1[d] = std::min(i + 1, src - 1);
    t.frac[d] = static_cast<float>(s - i);
  }
  return t;
}

}  // namespace

extern "C" {

// Bilinear resize (align_corners=False sampling) of an HWC uint8 RGB image
// into float32 [dh, dw, 3], then /255, - mean, / std per channel.
void resize_bilinear_normalize(const uint8_t* src, int sh, int sw,
                               float* dst, int dh, int dw,
                               const float* mean, const float* stddev) {
  const Taps rows = sample_taps(sh, dh);
  const Taps cols = sample_taps(sw, dw);
  std::vector<float> one_minus_fc(dw);
  for (int c = 0; c < dw; ++c) one_minus_fc[c] = 1.0f - cols.frac[c];
  for (int r = 0; r < dh; ++r) {
    const float fr = rows.frac[r];
    const float one_minus_fr = 1.0f - fr;
    const uint8_t* row0 = src + static_cast<int64_t>(rows.i0[r]) * sw * 3;
    const uint8_t* row1 = src + static_cast<int64_t>(rows.i1[r]) * sw * 3;
    float* out = dst + static_cast<int64_t>(r) * dw * 3;
    for (int c = 0; c < dw; ++c) {
      const float fc = cols.frac[c];
      const float gc = one_minus_fc[c];
      const int o0 = cols.i0[c] * 3, o1 = cols.i1[c] * 3;
      for (int ch = 0; ch < 3; ++ch) {
        const float top = static_cast<float>(row0[o0 + ch]) * gc +
                          static_cast<float>(row0[o1 + ch]) * fc;
        const float bot = static_cast<float>(row1[o0 + ch]) * gc +
                          static_cast<float>(row1[o1 + ch]) * fc;
        const float v = top * one_minus_fr + bot * fr;
        out[ch] = (v / 255.0f - mean[ch]) / stddev[ch];
      }
      out += 3;
    }
  }
}

// Scale and round padded [m, 4] boxes from original to resized image
// coordinates, leaving entries with label < 0 untouched. nearbyint rounds
// half to even, as numpy's np.round does.
void scale_boxes(float* boxes, const int32_t* labels, int m, float row_scale,
                 float col_scale) {
  for (int i = 0; i < m; ++i) {
    if (labels[i] < 0) continue;
    float* b = boxes + static_cast<int64_t>(i) * 4;
    b[0] = std::nearbyint(b[0] * row_scale);
    b[1] = std::nearbyint(b[1] * col_scale);
    b[2] = std::nearbyint(b[2] * row_scale);
    b[3] = std::nearbyint(b[3] * col_scale);
  }
}

}  // extern "C"

#ifndef FRCNN_NO_JPEG

namespace {

// libjpeg's default error handler exits the process; this one longjmps
// back so that a bad file is an error return.
struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

void jpeg_err_silent(j_common_ptr, int) {}
void jpeg_err_nomsg(j_common_ptr) {}

}  // namespace

extern "C" {

// Decode a JPEG from memory into the resize above and report the source's
// size (*orig_h, *orig_w: the reader scales the boxes by them). Grayscale
// and CMYK sources come out as RGB. With fast_scale != 0 libjpeg decodes
// at the smallest DCT-domain scale (1/2, 1/4, 1/8) that still covers
// (dh, dw). Returns 0 on success, -1 on a decode error.
int decode_jpeg_resize_normalize(const uint8_t* data, int64_t len,
                                 float* dst, int dh, int dw,
                                 const float* mean, const float* stddev,
                                 int fast_scale, int32_t* orig_h,
                                 int32_t* orig_w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  jerr.pub.emit_message = jpeg_err_silent;
  jerr.pub.output_message = jpeg_err_nomsg;
  std::vector<uint8_t> pixels;  // declared before setjmp: longjmp-safe
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  *orig_h = static_cast<int32_t>(cinfo.image_height);
  *orig_w = static_cast<int32_t>(cinfo.image_width);
  cinfo.out_color_space = JCS_RGB;
  if (fast_scale && dh > 0 && dw > 0) {
    for (int denom = 8; denom >= 2; denom /= 2) {
      if (static_cast<int>(cinfo.image_height) >= dh * denom &&
          static_cast<int>(cinfo.image_width) >= dw * denom) {
        cinfo.scale_num = 1;
        cinfo.scale_denom = denom;
        break;
      }
    }
  }
  jpeg_start_decompress(&cinfo);
  const int sh = static_cast<int>(cinfo.output_height);
  const int sw = static_cast<int>(cinfo.output_width);
  if (cinfo.output_components != 3 || sh <= 0 || sw <= 0) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  pixels.resize(static_cast<size_t>(sh) * sw * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row =
        pixels.data() + static_cast<size_t>(cinfo.output_scanline) * sw * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  resize_bilinear_normalize(pixels.data(), sh, sw, dst, dh, dw, mean, stddev);
  return 0;
}

}  // extern "C"

#endif  // FRCNN_NO_JPEG
