// Native JPEG codec shim over libjpeg (the jpeg62 ABI): the PyTorch
// port's own copy of infercam_onnx_tpu/native/csrc/jpeg_shim.cpp, with the
// same C ABI.
//
// Decompress to RGB8, compress from RGB8 with configurable quality and
// chroma subsampling, plus batch decode entry points that fan out across a
// std::thread pool: the server decodes frames from many concurrent streams
// per micro-batch, and the ctypes calls release the Python GIL meanwhile.
//
// Exposed as a plain C ABI consumed via ctypes (native/jpeg.py builds it
// with g++ at first use). Error handling: libjpeg's default error handler
// calls exit(); we install a setjmp-based handler so corrupt frames return
// an error code instead of killing the process.

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

void silence_output(j_common_ptr) {}

}  // namespace

extern "C" {

// Decode JPEG bytes to RGB8. On success returns 0 and fills *out_w/*out_h;
// the caller must have provided `out` with capacity >= max_bytes. Returns
// -1 on corrupt input, -2 if the decoded image exceeds max_bytes.
// scale_denom in {1,2,4,8} decodes at 1/scale_denom resolution via
// libjpeg's IDCT scaling (much cheaper than decode-then-resize and 4x
// fewer bytes at denom 2 — the fast path for model-input-only decode).
int ic_jpeg_decode_rgb_scaled(const uint8_t* data, int64_t len, uint8_t* out,
                              int64_t max_bytes, int32_t* out_w,
                              int32_t* out_h, int32_t scale_denom) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.output_message = silence_output;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  cinfo.out_color_space = JCS_RGB;
  if (scale_denom > 1) {
    cinfo.scale_num = 1;
    cinfo.scale_denom = static_cast<unsigned int>(scale_denom);
  }
  jpeg_start_decompress(&cinfo);
  const int64_t w = cinfo.output_width;
  const int64_t h = cinfo.output_height;
  const int64_t stride = w * 3;
  if (stride * h > max_bytes) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + static_cast<int64_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out_w = static_cast<int32_t>(w);
  *out_h = static_cast<int32_t>(h);
  return 0;
}

int ic_jpeg_decode_rgb(const uint8_t* data, int64_t len, uint8_t* out,
                       int64_t max_bytes, int32_t* out_w, int32_t* out_h) {
  return ic_jpeg_decode_rgb_scaled(data, len, out, max_bytes, out_w, out_h,
                                   1);
}

// Probe dimensions without decoding. Returns 0 on success.
int ic_jpeg_probe_scaled(const uint8_t* data, int64_t len, int32_t* out_w,
                         int32_t* out_h, int32_t scale_denom) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.output_message = silence_output;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  if (scale_denom > 1) {
    cinfo.scale_num = 1;
    cinfo.scale_denom = static_cast<unsigned int>(scale_denom);
  }
  jpeg_calc_output_dimensions(&cinfo);
  *out_w = static_cast<int32_t>(cinfo.output_width);
  *out_h = static_cast<int32_t>(cinfo.output_height);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Encode RGB8 to JPEG. subsamp: 0 = 4:4:4, 1 = 4:2:2, 2 = 4:2:0 (the
// reference server encodes 4:2:0 at quality 95).
// Returns the encoded size, or -1 on error / -2 if out buffer too small.
int64_t ic_jpeg_encode_rgb(const uint8_t* rgb, int32_t w, int32_t h,
                           int32_t quality, int32_t subsamp, uint8_t* out,
                           int64_t max_bytes) {
  jpeg_compress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.output_message = silence_output;

  // thread_local (not automatic) so the longjmp error path reads a
  // well-defined value: locals modified after setjmp are indeterminate
  // when read after longjmp (C semantics), and jpeg_mem_dest updates
  // these during compression.
  static thread_local uint8_t* buf;
  static thread_local unsigned long buf_size;
  buf = nullptr;
  buf_size = 0;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_compress(&cinfo);
    if (buf) free(buf);
    return -1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &buf, &buf_size);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  // chroma subsampling on the single luma component's sampling factors
  if (subsamp == 0) {
    cinfo.comp_info[0].h_samp_factor = 1;
    cinfo.comp_info[0].v_samp_factor = 1;
  } else if (subsamp == 1) {
    cinfo.comp_info[0].h_samp_factor = 2;
    cinfo.comp_info[0].v_samp_factor = 1;
  } else {
    cinfo.comp_info[0].h_samp_factor = 2;
    cinfo.comp_info[0].v_samp_factor = 2;
  }
  jpeg_start_compress(&cinfo, TRUE);
  const int64_t stride = static_cast<int64_t>(w) * 3;
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(
        rgb + static_cast<int64_t>(cinfo.next_scanline) * stride);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);

  int64_t n = static_cast<int64_t>(buf_size);
  if (n > max_bytes) {
    free(buf);
    return -2;
  }
  memcpy(out, buf, n);
  free(buf);
  return n;
}

int ic_jpeg_probe(const uint8_t* data, int64_t len, int32_t* out_w,
                  int32_t* out_h) {
  return ic_jpeg_probe_scaled(data, len, out_w, out_h, 1);
}

// Batch decode with a thread pool. Each output slot i gets status[i] (as
// ic_jpeg_decode_rgb) and dims in out_w[i]/out_h[i]; pixel data lands at
// outs + i * max_bytes_each.
void ic_jpeg_decode_batch(const uint8_t* const* datas, const int64_t* lens,
                          int32_t n, uint8_t* outs, int64_t max_bytes_each,
                          int32_t* out_w, int32_t* out_h, int32_t* status,
                          int32_t num_threads, int32_t scale_denom) {
  if (num_threads < 1) num_threads = 1;
  if (num_threads > n) num_threads = n;
  std::vector<std::thread> workers;
  std::atomic<int32_t> next{0};
  auto work = [&]() {
    while (true) {
      int32_t i = next.fetch_add(1);
      if (i >= n) break;
      status[i] = ic_jpeg_decode_rgb_scaled(
          datas[i], lens[i],
          outs + static_cast<int64_t>(i) * max_bytes_each, max_bytes_each,
          &out_w[i], &out_h[i], scale_denom);
    }
  };
  for (int t = 0; t < num_threads; ++t) workers.emplace_back(work);
  for (auto& th : workers) th.join();
}

}  // extern "C"

namespace {

#if JPEG_LIB_VERSION >= 80
inline int dct_scaled_size(const jpeg_component_info* c) {
  return c->DCT_v_scaled_size;
}
#else
inline int dct_scaled_size(const jpeg_component_info* c) {
  return c->DCT_scaled_size;
}
#endif

}  // namespace

extern "C" {

// Raw-plane decode: entropy decode + (scaled) IDCT on the host, NO chroma
// upsampling and NO color conversion — those run on the device
// (ops/jpeg_device.py, the ycbcr path). Compared to RGB decode this roughly
// halves host->device bytes for 4:2:0 (Y + Cb/4 + Cr/4 = 1.5 B/px vs
// 3 B/px) and skips ~30% of host decode work, which is exactly what the
// transfer-bound serving pipeline needs.
//
// The three planes are written CONSECUTIVELY into `out` (one packed
// buffer -> one host->device transfer): Y[y_ph][y_pw], Cb[c_ph][c_pw],
// Cr[c_ph][c_pw], where the padded dims are iMCU-aligned as libjpeg
// requires for raw output. dims_out[8]: out_w, out_h (true scaled frame
// dims), y_pw, y_ph, c_pw, c_ph (padded plane dims), h_samp, v_samp.
// Returns 0, -1 corrupt, -2 buffer too small, -3 unsupported layout
// (needs 3-component YCbCr, chroma 1x1, luma 2x2/2x1/1x1).
int ic_jpeg_decode_ycbcr_scaled(const uint8_t* data, int64_t len,
                                uint8_t* out, int64_t max_bytes,
                                int32_t scale_denom, int32_t* dims_out) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.output_message = silence_output;
  // constructed BEFORE setjmp so the longjmp error path returns through
  // live objects and their destructors run (no leak on corrupt input)
  std::vector<JSAMPROW> rows[3];
  JSAMPARRAY image[3];
  int rows_per_call[3];
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  if (cinfo.num_components != 3 ||
      cinfo.jpeg_color_space != JCS_YCbCr) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  const int hs = cinfo.comp_info[0].h_samp_factor;
  const int vs = cinfo.comp_info[0].v_samp_factor;
  const bool s420 = (hs == 2 && vs == 2);
  const bool s422 = (hs == 2 && vs == 1);  // what UVC webcams emit
  const bool s444 = (hs == 1 && vs == 1);
  if ((!s420 && !s422 && !s444) ||
      cinfo.comp_info[1].h_samp_factor != 1 ||
      cinfo.comp_info[1].v_samp_factor != 1 ||
      cinfo.comp_info[2].h_samp_factor != 1 ||
      cinfo.comp_info[2].v_samp_factor != 1) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  cinfo.raw_data_out = TRUE;
  if (scale_denom > 1) {
    cinfo.scale_num = 1;
    cinfo.scale_denom = static_cast<unsigned int>(scale_denom);
  }
  jpeg_start_decompress(&cinfo);

  // padded (iMCU-aligned) plane geometry after IDCT scaling
  int bs[3];
  int64_t pw[3], ph[3], plane_off[3];
  const JDIMENSION total_imcu_rows =
      (cinfo.output_height +
       static_cast<JDIMENSION>(cinfo.max_v_samp_factor *
                               dct_scaled_size(&cinfo.comp_info[0])) - 1) /
      (cinfo.max_v_samp_factor * dct_scaled_size(&cinfo.comp_info[0]));
  int64_t total = 0;
  for (int c = 0; c < 3; ++c) {
    jpeg_component_info* comp = &cinfo.comp_info[c];
    bs[c] = dct_scaled_size(comp);
    pw[c] = static_cast<int64_t>(comp->width_in_blocks) * bs[c];
    ph[c] = static_cast<int64_t>(total_imcu_rows) *
            comp->v_samp_factor * bs[c];
    plane_off[c] = total;
    total += pw[c] * ph[c];
  }
  if (total > max_bytes) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }

  // row-pointer scaffolding: per call, component c receives
  // v_samp_factor * DCT_scaled_size rows
  for (int c = 0; c < 3; ++c) {
    rows_per_call[c] = cinfo.comp_info[c].v_samp_factor * bs[c];
    rows[c].resize(rows_per_call[c]);
    image[c] = rows[c].data();
  }
  const JDIMENSION luma_lines_per_call =
      cinfo.max_v_samp_factor * bs[0];
  int64_t row_base[3] = {0, 0, 0};
  while (cinfo.output_scanline < cinfo.output_height) {
    for (int c = 0; c < 3; ++c) {
      for (int r = 0; r < rows_per_call[c]; ++r) {
        rows[c][r] = out + plane_off[c] +
                     (row_base[c] + r) * pw[c];
      }
    }
    JDIMENSION got =
        jpeg_read_raw_data(&cinfo, image, luma_lines_per_call);
    if (got == 0) {
      jpeg_abort_decompress(&cinfo);
      jpeg_destroy_decompress(&cinfo);
      return -1;
    }
    for (int c = 0; c < 3; ++c) row_base[c] += rows_per_call[c];
  }
  // With IDCT scaling, libjpeg scales chroma LESS on subsampled streams
  // (it can emerge at scaled-luma resolution), which would forfeit the
  // transfer saving. Fold chroma back to the natural subsampled
  // resolution with a rounded box average over the oversized axes, in
  // place (fold writes trail the reads). Handles 4:2:0 (2x2 fold) and
  // 4:2:2 (horizontal 2x1 fold).
  {
    const bool fold_w = (hs == 2 && pw[1] == pw[0]);
    const bool fold_h = (vs == 2 && ph[1] == ph[0]);
    if (fold_w || fold_h) {
      const int64_t fx = fold_w ? 2 : 1, fy = fold_h ? 2 : 1;
      const int64_t cw2 = pw[1] / fx, ch2 = ph[1] / fy;
      const int64_t csz2 = cw2 * ch2;
      const uint32_t norm = static_cast<uint32_t>(fx * fy);
      for (int c = 1; c < 3; ++c) {
        const uint8_t* src = out + plane_off[c];
        uint8_t* dst = out + pw[0] * ph[0] + (c - 1) * csz2;
        for (int64_t r = 0; r < ch2; ++r) {
          uint8_t* d = dst + r * cw2;
          for (int64_t x = 0; x < cw2; ++x) {
            uint32_t acc = 0;
            for (int64_t dy = 0; dy < fy; ++dy) {
              const uint8_t* s = src + (fy * r + dy) * pw[c];
              for (int64_t dx = 0; dx < fx; ++dx) {
                acc += s[fx * x + dx];
              }
            }
            d[x] = static_cast<uint8_t>((acc + norm / 2) / norm);
          }
        }
      }
      pw[1] = cw2;
      ph[1] = ch2;
    }
  }
  dims_out[0] = static_cast<int32_t>(cinfo.output_width);
  dims_out[1] = static_cast<int32_t>(cinfo.output_height);
  dims_out[2] = static_cast<int32_t>(pw[0]);
  dims_out[3] = static_cast<int32_t>(ph[0]);
  dims_out[4] = static_cast<int32_t>(pw[1]);
  dims_out[5] = static_cast<int32_t>(ph[1]);
  dims_out[6] = hs;
  dims_out[7] = vs;
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Threaded batch variant: slot i's packed planes land at
// outs + i * max_bytes_each, its dims at dims_out + i * 8, status[i] as
// ic_jpeg_decode_ycbcr_scaled.
void ic_jpeg_decode_ycbcr_batch(const uint8_t* const* datas,
                                const int64_t* lens, int32_t n,
                                uint8_t* outs, int64_t max_bytes_each,
                                int32_t* dims_out, int32_t* status,
                                int32_t num_threads,
                                int32_t scale_denom) {
  if (num_threads < 1) num_threads = 1;
  if (num_threads > n) num_threads = n;
  std::vector<std::thread> workers;
  std::atomic<int32_t> next{0};
  auto work = [&]() {
    while (true) {
      int32_t i = next.fetch_add(1);
      if (i >= n) break;
      status[i] = ic_jpeg_decode_ycbcr_scaled(
          datas[i], lens[i], outs + static_cast<int64_t>(i) * max_bytes_each,
          max_bytes_each, scale_denom, dims_out + i * 8);
    }
  };
  for (int t = 0; t < num_threads; ++t) workers.emplace_back(work);
  for (auto& th : workers) th.join();
}

}  // extern "C"

extern "C" {

// Entropy-decode only: export quantized DCT coefficient blocks + quant
// tables without running IDCT/upsampling/color conversion on the host.
// This is the host half of the device-side decode tail (host: entropy
// decode -> DCT coefficients; device: dequantization, the 8x8 IDCT, chroma
// upsampling and color conversion, ahead of detection).
//
// Requirements: baseline/progressive JPEG, 3 components, 4:2:0, 4:2:2,
// or 4:4:4 sampling. Coefficients and quant values are exported in natural
// (row-major) order, as libjpeg stores them.
//
// dims_out[8]: width, height, y_bw, y_bh, c_bw, c_bh, h_samp, v_samp.
// Plane buffers receive int16[bh][bw][64]. Returns 0, or -1 corrupt,
// -2 buffer too small, -3 unsupported layout.
// Export the quantization tables libjpeg would use at `quality`
// (jpeg_set_quality semantics, force_baseline=TRUE), in natural
// (row-major) order: out[0..63] luma, out[64..127] chroma. The device
// JPEG-encode tail quantizes with EXACTLY
// these tables so the host entropy encoder (ic_jpeg_write_coefs) can
// embed them verbatim. Returns 0.
int ic_jpeg_quant_tables(int32_t quality, uint16_t* out) {
  jpeg_compress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.output_message = silence_output;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_compress(&cinfo);
    return -1;
  }
  jpeg_create_compress(&cinfo);
  cinfo.image_width = 16;
  cinfo.image_height = 16;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  for (int t = 0; t < 2; ++t) {
    JQUANT_TBL* qt = cinfo.quant_tbl_ptrs[t];
    for (int k = 0; k < 64; ++k) out[t * 64 + k] = qt->quantval[k];
  }
  jpeg_destroy_compress(&cinfo);
  return 0;
}

// Entropy-encode pre-quantized DCT coefficient planes into a baseline
// JPEG (jpeg_write_coefficients): the host half of the DEVICE-side
// encode tail. The device program renders detection overlays into the
// YCbCr planes, runs the forward FDCT as matmuls and quantizes; this
// function only Huffman-codes the
// resulting int16 blocks — the encode mirror of ic_jpeg_read_coefs.
//
// Inputs are [in_bh][in_bw][64] int16 blocks in natural order per plane
// (in_* dims may exceed the JPEG's block dims — iMCU padding from the
// decode side — extras are ignored; missing padding blocks are zero).
// quant: 2*64 uint16 natural order (luma, chroma), typically from
// ic_jpeg_quant_tables. Returns encoded size, -1 error, -2 out buffer
// too small.
int64_t ic_jpeg_write_coefs(const int16_t* y, const int16_t* cb,
                            const int16_t* cr, int32_t in_y_bw,
                            int32_t in_y_bh, int32_t in_c_bw,
                            int32_t in_c_bh, int32_t w, int32_t h,
                            int32_t hs, int32_t vs, const uint16_t* quant,
                            uint8_t* out, int64_t max_bytes) {
  jpeg_compress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.output_message = silence_output;
  static thread_local uint8_t* buf;
  static thread_local unsigned long buf_size;
  buf = nullptr;
  buf_size = 0;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_compress(&cinfo);
    if (buf) free(buf);
    return -1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &buf, &buf_size);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_YCbCr;
  jpeg_set_defaults(&cinfo);
  cinfo.comp_info[0].h_samp_factor = hs;
  cinfo.comp_info[0].v_samp_factor = vs;
  cinfo.comp_info[1].h_samp_factor = 1;
  cinfo.comp_info[1].v_samp_factor = 1;
  cinfo.comp_info[2].h_samp_factor = 1;
  cinfo.comp_info[2].v_samp_factor = 1;
  {
    // force_baseline=FALSE: splice-path inputs may carry 16-bit quant
    // tables (libjpeg decodes them); clamping to 255 here would make
    // every decoder dequantize with wrong divisors
    unsigned int tbl[64];
    for (int t = 0; t < 2; ++t) {
      for (int k = 0; k < 64; ++k) tbl[k] = quant[t * 64 + k];
      jpeg_add_quant_table(&cinfo, t, tbl, 100, FALSE);
    }
  }
  cinfo.comp_info[0].quant_tbl_no = 0;
  cinfo.comp_info[1].quant_tbl_no = 1;
  cinfo.comp_info[2].quant_tbl_no = 1;

  // component block geometry (mirrors jpeg's master computation):
  // luma samp = (hs, vs) with max = (hs, vs); chroma samp = (1, 1)
  const int64_t y_bw = (static_cast<int64_t>(w) + 7) / 8;
  const int64_t y_bh = (static_cast<int64_t>(h) + 7) / 8;
  const int64_t c_bw = (static_cast<int64_t>(w) + 8 * hs - 1) / (8 * hs);
  const int64_t c_bh = (static_cast<int64_t>(h) + 8 * vs - 1) / (8 * vs);
  auto round_up = [](int64_t v, int64_t m) { return ((v + m - 1) / m) * m; };
  const int64_t dims[3][2] = {{y_bw, y_bh}, {c_bw, c_bh}, {c_bw, c_bh}};
  const int64_t samp[3][2] = {{hs, vs}, {1, 1}, {1, 1}};
  jvirt_barray_ptr arrays[3];
  for (int c = 0; c < 3; ++c) {
    arrays[c] = (*cinfo.mem->request_virt_barray)(
        reinterpret_cast<j_common_ptr>(&cinfo), JPOOL_IMAGE, FALSE,
        static_cast<JDIMENSION>(round_up(dims[c][0], samp[c][0])),
        static_cast<JDIMENSION>(round_up(dims[c][1], samp[c][1])),
        static_cast<JDIMENSION>(samp[c][1]));
  }
  jpeg_write_coefficients(&cinfo, arrays);

  const int16_t* ins[3] = {y, cb, cr};
  const int64_t in_bw[3] = {in_y_bw, in_c_bw, in_c_bw};
  const int64_t in_bh[3] = {in_y_bh, in_c_bh, in_c_bh};
  for (int c = 0; c < 3; ++c) {
    const int64_t bw_pad = round_up(dims[c][0], samp[c][0]);
    const int64_t bh_pad = round_up(dims[c][1], samp[c][1]);
    for (int64_t row = 0; row < bh_pad; ++row) {
      JBLOCKARRAY rows = (*cinfo.mem->access_virt_barray)(
          reinterpret_cast<j_common_ptr>(&cinfo), arrays[c],
          static_cast<JDIMENSION>(row), 1, TRUE);
      memset(rows[0], 0, sizeof(JBLOCK) * bw_pad);
      if (row < in_bh[c]) {
        const int64_t ncols = bw_pad < in_bw[c] ? bw_pad : in_bw[c];
        memcpy(rows[0], ins[c] + row * in_bw[c] * 64,
               sizeof(JCOEF) * 64 * ncols);
      }
    }
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);

  int64_t n = static_cast<int64_t>(buf_size);
  if (n > max_bytes) {
    free(buf);
    return -2;
  }
  memcpy(out, buf, n);
  free(buf);
  return n;
}

int ic_jpeg_read_coefs(const uint8_t* data, int64_t len, int16_t* out_y,
                       int16_t* out_cb, int16_t* out_cr,
                       int64_t max_coefs_each, uint16_t* quant_out,
                       int32_t* dims_out) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.output_message = silence_output;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  if (cinfo.num_components != 3 ||
      cinfo.jpeg_color_space != JCS_YCbCr) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  jvirt_barray_ptr* coefs = jpeg_read_coefficients(&cinfo);
  if (coefs == nullptr) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  const int hs = cinfo.comp_info[0].h_samp_factor;
  const int vs = cinfo.comp_info[0].v_samp_factor;
  const bool s420 = (hs == 2 && vs == 2);
  const bool s422 = (hs == 2 && vs == 1);
  const bool s444 = (hs == 1 && vs == 1);
  if ((!s420 && !s422 && !s444) ||
      cinfo.comp_info[1].h_samp_factor != 1 ||
      cinfo.comp_info[1].v_samp_factor != 1 ||
      cinfo.comp_info[2].h_samp_factor != 1 ||
      cinfo.comp_info[2].v_samp_factor != 1) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }

  int16_t* outs[3] = {out_y, out_cb, out_cr};
  for (int c = 0; c < 3; ++c) {
    jpeg_component_info* comp = &cinfo.comp_info[c];
    const JDIMENSION bw = comp->width_in_blocks;
    const JDIMENSION bh = comp->height_in_blocks;
    if (static_cast<int64_t>(bw) * bh * 64 > max_coefs_each) {
      jpeg_destroy_decompress(&cinfo);
      return -2;
    }
    JQUANT_TBL* qt = cinfo.quant_tbl_ptrs[comp->quant_tbl_no];
    if (qt == nullptr) {
      jpeg_destroy_decompress(&cinfo);
      return -1;
    }
    for (int k = 0; k < 64; ++k) quant_out[c * 64 + k] = qt->quantval[k];
    for (JDIMENSION row = 0; row < bh; ++row) {
      JBLOCKARRAY rows = (*cinfo.mem->access_virt_barray)(
          reinterpret_cast<j_common_ptr>(&cinfo), coefs[c], row, 1,
          FALSE);
      memcpy(outs[c] + static_cast<int64_t>(row) * bw * 64, rows[0],
             sizeof(JCOEF) * 64 * bw);
    }
    if (c == 0) {
      dims_out[2] = static_cast<int32_t>(bw);
      dims_out[3] = static_cast<int32_t>(bh);
    } else if (c == 1) {
      dims_out[4] = static_cast<int32_t>(bw);
      dims_out[5] = static_cast<int32_t>(bh);
    }
  }
  dims_out[0] = static_cast<int32_t>(cinfo.image_width);
  dims_out[1] = static_cast<int32_t>(cinfo.image_height);
  dims_out[6] = hs;
  dims_out[7] = vs;
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"
