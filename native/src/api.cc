// C API for the spdf engine (ctypes-friendly). Page metadata crosses the
// boundary as JSON; pixel buffers as malloc'd RGB8 the caller frees.
#include <cmath>
#include "spdf.h"

#include <zlib.h>

#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>

using namespace spdf;

namespace {

struct DocHandle {
  Document doc;
  // cached per-page extraction (content runs once; render reuses).
  // Mutex: Python calls in from a prefetch thread and the consume thread
  // concurrently (ctypes releases the GIL during foreign calls).
  std::mutex mu;
  std::unordered_map<int, std::shared_ptr<std::pair<PageContent, DisplayList>>>
      pages;
  std::shared_ptr<std::pair<PageContent, DisplayList>> get_page(int i) {
    auto it = pages.find(i);
    if (it != pages.end()) return it->second;
    auto pc = std::make_shared<std::pair<PageContent, DisplayList>>();
    ContentEngine eng(&doc);
    eng.run(i, &pc->first, &pc->second);
    pages[i] = pc;
    return pc;
  }
};

void json_escape(const std::string& s, std::string* out) {
  for (unsigned char c : s) {
    switch (c) {
      case '"': *out += "\\\""; break;
      case '\\': *out += "\\\\"; break;
      case '\n': *out += "\\n"; break;
      case '\r': *out += "\\r"; break;
      case '\t': *out += "\\t"; break;
      default:
        if (c < 0x20) {
          char buf[8];
          snprintf(buf, sizeof(buf), "\\u%04x", c);
          *out += buf;
        } else {
          *out += (char)c;
        }
    }
  }
}

void append_rect(std::string* j, const Rect& r) {
  char buf[128];
  snprintf(buf, sizeof(buf), "[%.3f,%.3f,%.3f,%.3f]", r.x0, r.y0, r.x1, r.y1);
  *j += buf;
}

// ---- Pillow-parity bilinear resample, single 8-bit band ----------------
//
// Bit-identical to PIL Image.resize(..., Image.BILINEAR) on mode-L
// images (Pillow Resample.c): triangle filter whose support scales with
// the downscale factor, per-output-pixel coefficient windows normalized
// in double then rounded to 22-bit fixed point, horizontal pass then
// vertical pass, accumulator seeded with the half-ulp rounding bias.
// The OCR line-tile builder (spdf_line_tiles) must reproduce the Python
// ocr/processor._line_tile pixels exactly — the recognizer was trained
// on PIL-resized tiles, so "close" resampling is not good enough
// (locked by tests/test_ocr.py native-parity cases).
constexpr int kPrecisionBits = 32 - 8 - 2;

inline uint8_t pil_clip8(int in) {
  if (in >= (1 << kPrecisionBits << 8)) return 255;
  if (in <= 0) return 0;
  return (uint8_t)(in >> kPrecisionBits);
}

// coefficient windows for one axis: bounds (xmin, xmax) per output px +
// ksize fixed-point taps per output px
static int pil_coeffs(int in_size, int out_size, std::vector<int>* bounds,
                      std::vector<int>* kk) {
  double scale = (double)in_size / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 1.0 * filterscale;  // bilinear filter support = 1.0
  int ksize = (int)std::ceil(support) * 2 + 1;
  bounds->assign((size_t)out_size * 2, 0);
  std::vector<double> prekk((size_t)out_size * ksize, 0.0);
  double ss = 1.0 / filterscale;
  for (int xx = 0; xx < out_size; xx++) {
    double center = (xx + 0.5) * scale;
    double ww = 0.0;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = prekk.data() + (size_t)xx * ksize;
    for (int x = 0; x < xmax; x++) {
      double wgt = (x + xmin - center + 0.5) * ss;
      wgt = wgt < 0 ? 1.0 + wgt : 1.0 - wgt;  // triangle filter
      if (wgt < 0) wgt = 0;
      k[x] = wgt;
      ww += wgt;
    }
    if (ww != 0.0)
      for (int x = 0; x < xmax; x++) k[x] /= ww;
    (*bounds)[xx * 2] = xmin;
    (*bounds)[xx * 2 + 1] = xmax;
  }
  kk->resize(prekk.size());
  for (size_t i = 0; i < prekk.size(); i++)
    (*kk)[i] = (int)(prekk[i] < 0
                         ? prekk[i] * (1 << kPrecisionBits) - 0.5
                         : prekk[i] * (1 << kPrecisionBits) + 0.5);
  return ksize;
}

// (sh, sw) 8-bit gray -> (oh, ow), PIL BILINEAR semantics
static void pil_resize_gray(const uint8_t* src, int sh, int sw,
                            uint8_t* dst, int oh, int ow) {
  std::vector<int> hb, hk, vb, vk;
  const uint8_t* cur = src;
  int cw = sw;
  std::vector<uint8_t> tmp;
  if (ow != sw) {  // horizontal pass (PIL skips it for identity widths)
    int ks = pil_coeffs(sw, ow, &hb, &hk);
    tmp.resize((size_t)sh * ow);
    for (int y = 0; y < sh; y++) {
      const uint8_t* row = cur + (size_t)y * sw;
      uint8_t* orow = tmp.data() + (size_t)y * ow;
      for (int xx = 0; xx < ow; xx++) {
        int xmin = hb[xx * 2], xmax = hb[xx * 2 + 1];
        const int* k = hk.data() + (size_t)xx * ks;
        int acc = 1 << (kPrecisionBits - 1);
        for (int x = 0; x < xmax; x++) acc += row[x + xmin] * k[x];
        orow[xx] = pil_clip8(acc);
      }
    }
    cur = tmp.data();
    cw = ow;
  }
  if (oh != sh) {  // vertical pass
    int ks = pil_coeffs(sh, oh, &vb, &vk);
    for (int yy = 0; yy < oh; yy++) {
      int ymin = vb[yy * 2], ymax = vb[yy * 2 + 1];
      const int* k = vk.data() + (size_t)yy * ks;
      uint8_t* orow = dst + (size_t)yy * ow;
      for (int xx = 0; xx < ow; xx++) {
        int acc = 1 << (kPrecisionBits - 1);
        for (int y = 0; y < ymax; y++)
          acc += cur[(size_t)(y + ymin) * cw + xx] * k[y];
        orow[xx] = pil_clip8(acc);
      }
    }
  } else {
    memcpy(dst, cur, (size_t)oh * ow);
  }
}

}  // namespace

extern "C" {

void* spdf_open_pw(const char* path, const char* password) {
  auto* h = new DocHandle();
  if (!h->doc.load(path, password ? password : "")) {
    delete h;
    return nullptr;
  }
  return h;
}

void* spdf_open(const char* path) { return spdf_open_pw(path, ""); }

void* spdf_open_bytes_pw(const uint8_t* data, long size,
                         const char* password) {
  auto* h = new DocHandle();
  std::vector<uint8_t> b(data, data + size);
  if (!h->doc.load_bytes(std::move(b), password ? password : "")) {
    delete h;
    return nullptr;
  }
  return h;
}

void* spdf_open_bytes(const uint8_t* data, long size) {
  return spdf_open_bytes_pw(data, size, "");
}

void spdf_close(void* handle) { delete (DocHandle*)handle; }

// Register the host JPEG2000 decoder (see spdf.h::JpxDecodeCb). Called once
// at library load by the Python binding; pass nullptr to unregister. The
// callback may be invoked from any thread that renders or decodes images
// (ctypes callbacks re-acquire the GIL via PyGILState_Ensure).
void spdf_set_jpx_decoder(JpxDecodeCb cb) { g_jpx_decode_cb = cb; }

// Directory of the packaged DejaVu fonts that stand in for non-embedded
// fonts. Called once at library load by the Python binding.
void spdf_set_font_dir(const char* dir) { g_font_dir = dir ? dir : ""; }

// PIL-parity bilinear resize of one (sh, sw) 8-bit gray image into a
// caller-allocated (oh, ow) buffer (see pil_resize_gray).
void spdf_resize_gray(const uint8_t* src, int sh, int sw, uint8_t* dst,
                      int oh, int ow) {
  pil_resize_gray(src, sh, sw, dst, oh, ow);
}

int spdf_page_count(void* handle) {
  // page_count()/page_size() resolve objects and can mutate the document's
  // caches (indirect attrs, lazy object streams); callers run concurrently
  // with render/metadata threads (ctypes drops the GIL), so every entry
  // point takes the handle mutex.
  auto* h = (DocHandle*)handle;
  std::lock_guard<std::mutex> lock(h->mu);
  return h->doc.page_count();
}

void spdf_page_size(void* handle, int index, double* w, double* h) {
  auto* hd = (DocHandle*)handle;
  std::lock_guard<std::mutex> lock(hd->mu);
  hd->doc.page_size(index, w, h);
}

// JSON: {"spans": [{"text","bbox","size","font"}...],
//        "drawings": [{"bbox","kind","is_rect","items"}...],
//        "images": [{"obj","bbox","width","height","inline"}...]}
char* spdf_page_metadata(void* handle, int index) {
  auto* h = (DocHandle*)handle;
  std::lock_guard<std::mutex> lock(h->mu);
  auto pc = h->get_page(index);
  std::string j = "{\"spans\":[";
  bool first = true;
  for (auto& s : pc->first.spans) {
    if (!first) j += ",";
    first = false;
    j += "{\"text\":\"";
    json_escape(s.text, &j);
    j += "\",\"bbox\":";
    append_rect(&j, s.bbox);
    char buf[96];
    snprintf(buf, sizeof(buf), ",\"size\":%.2f,\"font\":\"", s.size);
    j += buf;
    json_escape(s.font, &j);
    j += "\"}";
  }
  j += "],\"drawings\":[";
  first = true;
  for (auto& d : pc->first.drawings) {
    if (!first) j += ",";
    first = false;
    j += "{\"bbox\":";
    append_rect(&j, d.bbox);
    char buf[96];
    snprintf(buf, sizeof(buf), ",\"kind\":%d,\"is_rect\":%s,\"items\":%d}",
             d.kind, d.is_rect ? "true" : "false", d.item_count);
    j += buf;
  }
  j += "],\"images\":[";
  first = true;
  for (auto& im : pc->first.images) {
    if (!first) j += ",";
    first = false;
    j += "{\"obj\":";
    j += std::to_string(im.obj_num);
    j += ",\"bbox\":";
    append_rect(&j, im.rect);
    char buf[96];
    snprintf(buf, sizeof(buf), ",\"width\":%d,\"height\":%d,\"inline\":%s}",
             im.width, im.height, im.inline_image ? "true" : "false");
    j += buf;
  }
  j += "]}";
  char* out = (char*)malloc(j.size() + 1);
  memcpy(out, j.data(), j.size() + 1);
  return out;
}

// Render page region. clip = [x0,y0,x1,y1] page pts top-left origin or null.
// Returns malloc'd RGB8 buffer, sets out_w/out_h.
uint8_t* spdf_render(void* handle, int index, double scale,
                     const double* clip, int* out_w, int* out_h) {
  auto* h = (DocHandle*)handle;
  std::lock_guard<std::mutex> lock(h->mu);
  auto pc = h->get_page(index);
  std::vector<uint8_t> px =
      rasterize(&h->doc, pc->second, scale, clip, out_w, out_h);
  if (px.empty()) return nullptr;
  uint8_t* out = (uint8_t*)malloc(px.size());
  memcpy(out, px.data(), px.size());
  return out;
}

// Decode an embedded image XObject to RGB8. Fills the document-level
// decoded-image cache (spdf.h::Document::img_cache) so the subsequent
// region rasterizations reuse this decode instead of redoing it — the
// detection pass decodes every embedded image for variance validation
// right before the region renders draw the same image.
uint8_t* spdf_decode_image(void* handle, int obj_num, int* w, int* h) {
  auto* hd = (DocHandle*)handle;
  std::lock_guard<std::mutex> lock(hd->mu);
  if (hd->doc.img_cache_bytes > Document::kImgCacheCap) {
    hd->doc.img_cache.clear();
    hd->doc.img_cache_bytes = 0;
  }
  auto& ci = hd->doc.img_cache[obj_num];
  if (!ci.rgb_done) {
    ObjPtr xo = hd->doc.get_object(obj_num);
    ci.rgb = decode_image_rgb_obj(&hd->doc, xo, &ci.w, &ci.h);
    ci.rgb_done = true;
    hd->doc.img_cache_bytes += ci.rgb.size();
  }
  if (ci.rgb.empty()) return nullptr;
  *w = ci.w;
  *h = ci.h;
  uint8_t* out = (uint8_t*)malloc(ci.rgb.size());
  memcpy(out, ci.rgb.data(), ci.rgb.size());
  return out;
}

// PNG-encode an RGB8 buffer: fixed per-path row filter + zlib level 1.
//
// The pipeline writes one 150-DPI crop PNG per segment; PIL's encoder
// spends most of its time trying all five PNG row filters per row
// (adaptive heuristic). Fixed filters + fast deflate cut the per-crop
// host cost several-fold.
//
// Crops with <= 256 distinct colors take the palettized PNG8 path —
// filter NONE + Z_RLE deflate over 1 byte/px (flat fills + text on
// white are long index runs).
//
// Truecolor crops (charts with gradients/antialiased color blends
// exceed 256 colors more often than expected — measured p50 of 838
// distinct colors on the bench book) use the UP row filter + Z_RLE:
// vertically-smooth content becomes near-zero delta rows that
// run-length match, which measured BOTH faster (deflate 9.8 -> 6.8
// ms/crop: fewer Huffman-coded literals) and smaller (146 -> 104 KB
// avg) than unfiltered level-1 full-matcher deflate. Both paths emit
// spec-conformant lossless PNGs.
// Returns malloc'd PNG bytes, sets *out_len; caller frees via spdf_free.
uint8_t* spdf_png_encode(const uint8_t* rgb, int w, int h, long* out_len) {
  *out_len = 0;
  if (!rgb || w <= 0 || h <= 0) return nullptr;
  const size_t stride = (size_t)w * 3;
  const size_t n_px = (size_t)w * (size_t)h;

  // ---- try to palettize: open-addressed map of 24-bit colors ----------
  // 2048 slots (power of two); key = color | 0x80000000 marks occupancy.
  // A last-color fast path makes runs (white background) ~1 compare/px.
  std::vector<uint8_t> idx(n_px);
  uint32_t slots[2048];
  memset(slots, 0, sizeof(slots));
  uint8_t slot_idx[2048];
  std::vector<uint8_t> palette;  // r,g,b triplets
  palette.reserve(256 * 3);
  int n_colors = 0;
  uint32_t last_color = 0xffffffffu;
  uint8_t last_idx = 0;
  bool palettized = true;
  for (size_t i = 0; i < n_px; i++) {
    const uint8_t* p = rgb + i * 3;
    uint32_t c = ((uint32_t)p[0] << 16) | ((uint32_t)p[1] << 8) | p[2];
    if (c == last_color) {
      idx[i] = last_idx;
      continue;
    }
    uint32_t key = c | 0x80000000u;
    uint32_t slot = (c * 2654435761u) >> 21;  // top 11 bits
    while (true) {
      uint32_t s = slots[slot & 2047];
      if (s == key) break;
      if (s == 0) {
        if (n_colors == 256) { palettized = false; break; }
        slots[slot & 2047] = key;
        slot_idx[slot & 2047] = (uint8_t)n_colors;
        palette.push_back(p[0]);
        palette.push_back(p[1]);
        palette.push_back(p[2]);
        n_colors++;
        break;
      }
      slot++;
    }
    if (!palettized) break;
    last_color = c;
    last_idx = slot_idx[slot & 2047];
    idx[i] = last_idx;
  }

  // ---- raw scanlines (filter byte 0 per row) ---------------------------
  // Indexed images use the narrowest legal bit depth (1/2/4/8): page
  // renders are typically few-color (text + chart ink on white), and a
  // 2-color page at 1 bpp feeds deflate 8x fewer bytes — the deflate
  // pass is the dominant encode cost, so packed rows cut it near-
  // proportionally while also shrinking output.
  int bit_depth = 8;
  if (palettized) {
    bit_depth = n_colors <= 2 ? 1 : n_colors <= 4 ? 2 : n_colors <= 16 ? 4 : 8;
  }
  std::vector<uint8_t> raw;
  if (palettized && bit_depth < 8) {
    const int px_per_byte = 8 / bit_depth;
    const size_t rb = ((size_t)w * bit_depth + 7) / 8;  // packed row bytes
    raw.assign((rb + 1) * (size_t)h, 0);
    for (int y = 0; y < h; y++) {
      uint8_t* row = raw.data() + (rb + 1) * (size_t)y;
      row[0] = 0;
      const uint8_t* src = idx.data() + (size_t)w * (size_t)y;
      uint8_t* out = row + 1;
      int x = 0;
      for (size_t b = 0; b < rb; b++) {
        uint8_t acc = 0;
        for (int k = 0; k < px_per_byte && x < w; k++, x++)
          acc |= (uint8_t)(src[x] << (8 - bit_depth * (k + 1)));
        out[b] = acc;
      }
    }
  } else if (palettized) {
    raw.resize(((size_t)w + 1) * (size_t)h);
    for (int y = 0; y < h; y++) {
      uint8_t* row = raw.data() + ((size_t)w + 1) * (size_t)y;
      row[0] = 0;
      memcpy(row + 1, idx.data() + (size_t)w * (size_t)y, w);
    }
  } else {
    raw.resize((stride + 1) * (size_t)h);
    for (int y = 0; y < h; y++) {
      uint8_t* row = raw.data() + (stride + 1) * (size_t)y;
      row[0] = 2;  // filter: UP (first row's prior is all zeros per spec)
      const uint8_t* cur = rgb + stride * (size_t)y;
      if (y == 0) {
        memcpy(row + 1, cur, stride);
      } else {
        const uint8_t* above = cur - stride;
        uint8_t* out = row + 1;
        for (size_t i = 0; i < stride; i++) out[i] = (uint8_t)(cur[i] - above[i]);
      }
    }
  }
  // Z_RLE restricts match search to run-length matches (distance 1):
  // ~3x faster than the level-1 full matcher on these scanlines.
  // Palettized line art (long flat index runs) and UP-filtered truecolor
  // (near-zero delta runs) both compress at or below the full matcher.
  uLongf bound = compressBound((uLong)raw.size());
  std::vector<uint8_t> idat(bound);
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (deflateInit2(&zs, 1, Z_DEFLATED, 15, 8, Z_RLE) != Z_OK)
    return nullptr;
  zs.next_in = (Bytef*)raw.data();
  zs.avail_in = (uInt)raw.size();
  zs.next_out = idat.data();
  zs.avail_out = (uInt)bound;
  int zrc = deflate(&zs, Z_FINISH);
  deflateEnd(&zs);
  if (zrc != Z_STREAM_END) return nullptr;
  bound = (uLongf)(bound - zs.avail_out);

  std::vector<uint8_t> png;
  png.reserve(bound + 64 + palette.size());
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a,
                                 '\n'};
  png.insert(png.end(), sig, sig + 8);
  auto be32 = [](uint32_t v, uint8_t* p) {
    p[0] = v >> 24; p[1] = v >> 16; p[2] = v >> 8; p[3] = v;
  };
  auto chunk = [&](const char* type, const uint8_t* data, size_t n) {
    uint8_t hdr[8];
    be32((uint32_t)n, hdr);
    memcpy(hdr + 4, type, 4);
    png.insert(png.end(), hdr, hdr + 8);
    if (n) png.insert(png.end(), data, data + n);
    uLong crc = crc32(0L, (const Bytef*)type, 4);
    if (n) crc = crc32(crc, data, (uInt)n);
    uint8_t cb[4];
    be32((uint32_t)crc, cb);
    png.insert(png.end(), cb, cb + 4);
  };
  uint8_t ihdr[13];
  be32((uint32_t)w, ihdr);
  be32((uint32_t)h, ihdr + 4);
  ihdr[8] = (uint8_t)(palettized ? bit_depth : 8);  // bit depth
  ihdr[9] = palettized ? 3 : 2;        // color type: indexed / truecolor
  ihdr[10] = ihdr[11] = ihdr[12] = 0;  // deflate / filter 0 / no interlace
  chunk("IHDR", ihdr, 13);
  if (palettized) chunk("PLTE", palette.data(), palette.size());
  chunk("IDAT", idat.data(), bound);
  chunk("IEND", nullptr, 0);

  uint8_t* out = (uint8_t*)malloc(png.size());
  memcpy(out, png.data(), png.size());
  *out_len = (long)png.size();
  return out;
}

// Fused luma + 2x2-strided subsample over a crop batch — the analyze
// pass's H2D prep (ops/color.gray_quarter_host). The numpy version
// makes uint16 temporaries; this single pass runs at memory speed and
// releases the GIL via ctypes. gray: (n,h,w) uint8, integer luma
// (77,150,29)/256 with rounding — bit-identical to the numpy path.
// rgbq: (n,h/2,w/2,3) uint8. Caller allocates both outputs.
void spdf_gray_quarter(const uint8_t* rgb, int n, int h, int w,
                       uint8_t* gray, uint8_t* rgbq) {
  const int hq = h / 2, wq = w / 2;
  for (int i = 0; i < n; i++) {
    const uint8_t* src = rgb + (size_t)i * h * w * 3;
    uint8_t* g = gray + (size_t)i * h * w;
    uint8_t* q = rgbq + (size_t)i * hq * wq * 3;
    for (int y = 0; y < h; y++) {
      const uint8_t* row = src + (size_t)y * w * 3;
      uint8_t* grow = g + (size_t)y * w;
      for (int x = 0; x < w; x++) {
        const uint8_t* p = row + x * 3;
        grow[x] =
            (uint8_t)((77 * p[0] + 150 * p[1] + 29 * p[2] + 128) >> 8);
      }
      if ((y & 1) == 0 && (y >> 1) < hq) {
        uint8_t* qrow = q + (size_t)(y >> 1) * wq * 3;
        for (int x = 0; x < wq; x++) {
          const uint8_t* p = row + (size_t)(x * 2) * 3;
          qrow[x * 3] = p[0];
          qrow[x * 3 + 1] = p[1];
          qrow[x * 3 + 2] = p[2];
        }
      }
    }
  }
}

// Ink-preserving downscale of an RGB8 image to (oh, ow). Replaces the
// second fitted-DPI rasterization of oversized regions.
//
// Pure area averaging (a coverage-exact box filter) matches the integral
// the rasterizer's antialiasing computes at the lower DPI — but that
// integral LIGHTENS sub-pixel strokes (a 1px stroke at 150 DPI becomes
// ~0.7-coverage gray at fitted DPI), and the device feature pass
// binarizes ink at gray<200 (ops/filters.binarize_ink): lightened
// strokes break the morphological h/v line runs and line charts stop
// classifying (measured: 'line' -> 'unknown' on the e2e fixture). The
// direct fitted-DPI render never had this problem because the rasterizer
// draws each stroke with >=1px of near-full coverage at ANY scale.
//
// So after averaging, each output pixel is rescaled by
// (min luma over its footprint) / (average luma): uniform interiors are
// untouched (min == avg), while any footprint containing ink keeps the
// ink's darkness — strokes stay dark and connected at the cost of ~1px
// dilation, mirroring the rasterizer's minimum-stroke-width behavior.
// Hue is preserved because all three channels scale together.
// Separable: horizontal into a float accumulator, then vertical.
// Caller allocates dst (oh*ow*3).
void spdf_box_downscale(const uint8_t* src, int h, int w, uint8_t* dst,
                        int oh, int ow) {
  if (h <= 0 || w <= 0 || oh <= 0 || ow <= 0) return;
  // horizontal pass: (h, w, 3) u8 -> (h, ow, 3) float. Scratch buffers
  // are thread_local: ~4MB of fresh value-initialized vectors per call
  // cost page faults + memset at this call rate (one call per region);
  // reuse amortizes them away. tmin/tink are (re)filled per row below, so stale
  // contents never leak between calls.
  static thread_local std::vector<float> tmp;
  tmp.resize((size_t)h * ow * 3);
  const double sx = (double)w / ow;
  // precompute per-output-column input spans + edge weights
  static thread_local std::vector<int> x0, x1;
  static thread_local std::vector<float> wx0, wx1;
  x0.resize(ow); x1.resize(ow); wx0.resize(ow); wx1.resize(ow);
  for (int j = 0; j < ow; j++) {
    double a = j * sx, b = (j + 1) * sx;
    if (b > w) b = w;
    int ia = (int)a, ib = (int)std::ceil(b);
    x0[j] = ia;
    x1[j] = ib;
    wx0[j] = (float)(1.0 - (a - ia));        // coverage of first px
    wx1[j] = (float)(b - (ib - 1));          // coverage of last px
    if (ib - ia == 1) wx0[j] = (float)(b - a);  // span within one px
  }
  // per-(row, out-col): min luma and ink-coverage over the span (every
  // element is overwritten in the row loop, so reuse needs no refill)
  static thread_local std::vector<uint8_t> tmin;
  static thread_local std::vector<float> tink;
  tmin.resize((size_t)h * ow);
  tink.resize((size_t)h * ow);
  // per-row luma precompute: adjacent output columns overlap on edge
  // input pixels, so the span loop would recompute each pixel's luma
  // up to twice; one vectorizable pass over the row computes it once
  // (values identical — only the luma computation moves, the float
  // accumulation order below is unchanged, so output stays bit-exact)
  static thread_local std::vector<uint8_t> lrow;
  lrow.resize((size_t)w);
  for (int y = 0; y < h; y++) {
    const uint8_t* row = src + (size_t)y * w * 3;
    float* trow = tmp.data() + (size_t)y * ow * 3;
    uint8_t* mrow = tmin.data() + (size_t)y * ow;
    float* krow = tink.data() + (size_t)y * ow;
    for (int x = 0; x < w; x++) {
      const uint8_t* p = row + (size_t)x * 3;
      lrow[x] = (uint8_t)((77 * p[0] + 150 * p[1] + 29 * p[2] + 128) >> 8);
    }
    for (int j = 0; j < ow; j++) {
      float acc0 = 0, acc1 = 0, acc2 = 0, kacc = 0;
      int ia = x0[j], ib = x1[j];
      uint8_t mn = 255;
      for (int x = ia; x < ib; x++) {
        float wgt = (x == ia) ? wx0[j] : (x == ib - 1 ? wx1[j] : 1.0f);
        const uint8_t* p = row + (size_t)x * 3;
        acc0 += wgt * p[0];
        acc1 += wgt * p[1];
        acc2 += wgt * p[2];
        uint8_t lum = lrow[x];
        if (lum < mn) mn = lum;
        if (lum < 200) kacc += wgt;  // binarize_ink threshold
      }
      float inv = (float)(1.0 / sx);
      trow[j * 3] = acc0 * inv;
      trow[j * 3 + 1] = acc1 * inv;
      trow[j * 3 + 2] = acc2 * inv;
      mrow[j] = mn;
      krow[j] = kacc * inv;
    }
  }
  // vertical pass: -> (oh, ow, 3) u8, ink-coverage-blended toward min
  const double sy = (double)h / oh;
  std::vector<float> acc((size_t)ow * 3);
  std::vector<float> kcol((size_t)ow);
  std::vector<uint8_t> mcol((size_t)ow);
  for (int i = 0; i < oh; i++) {
    double a = i * sy, b = (i + 1) * sy;
    if (b > h) b = h;
    int ia = (int)a, ib = (int)std::ceil(b);
    float w0 = (float)(1.0 - (a - ia));
    float w1 = (float)(b - (ib - 1));
    if (ib - ia == 1) w0 = (float)(b - a);
    uint8_t* out = dst + (size_t)i * ow * 3;
    std::fill(acc.begin(), acc.end(), 0.0f);
    std::fill(kcol.begin(), kcol.end(), 0.0f);
    std::fill(mcol.begin(), mcol.end(), (uint8_t)255);
    for (int y = ia; y < ib; y++) {
      float wgt = (y == ia) ? w0 : (y == ib - 1 ? w1 : 1.0f);
      const float* trow = tmp.data() + (size_t)y * ow * 3;
      const uint8_t* mrow = tmin.data() + (size_t)y * ow;
      const float* krow = tink.data() + (size_t)y * ow;
      for (int k = 0; k < ow * 3; k++) acc[k] += wgt * trow[k];
      for (int j = 0; j < ow; j++) {
        kcol[j] += wgt * krow[j];
        if (mrow[j] < mcol[j]) mcol[j] = mrow[j];
      }
    }
    float inv = (float)(1.0 / sy);
    for (int j = 0; j < ow; j++) {
      float r = acc[j * 3] * inv, g = acc[j * 3 + 1] * inv,
            bch = acc[j * 3 + 2] * inv;
      // blend each channel toward the footprint\'s darkest ink by the
      // fraction of the footprint that IS ink: a sub-pixel stroke\'s core
      // (coverage ~0.7 after a 1.5x downscale) stays below the
      // binarize_ink threshold like the fitted-DPI rasterizer would have
      // drawn it, while low-coverage halo pixels stay near the plain
      // average (no stroke dilation, pie/wedge edge structure intact)
      float f = kcol[j] * inv;
      if (f > 1.0f) f = 1.0f;
      float lum = (77.0f * r + 150.0f * g + 29.0f * bch) * (1.0f / 256.0f);
      float s = 1.0f;
      if (lum > 0.5f) {
        float target = lum + (mcol[j] - lum) * f;
        s = target / lum;
        if (s > 1.0f) s = 1.0f;
      }
      float v0 = r * s + 0.5f, v1 = g * s + 0.5f, v2 = bch * s + 0.5f;
      out[j * 3] = (uint8_t)(v0 < 0 ? 0 : (v0 > 255 ? 255 : v0));
      out[j * 3 + 1] = (uint8_t)(v1 < 0 ? 0 : (v1 > 255 ? 255 : v1));
      out[j * 3 + 2] = (uint8_t)(v2 < 0 ? 0 : (v2 > 255 ? 255 : v2));
    }
  }
}

// Build normalized OCR line tiles from one source image — the batched
// native form of ocr/processor.TPUOCR._line_tile, bit-identical to the
// Python path (which replaces the reference's per-crop PaddleOCR tile
// prep, ref pdf_image_segmentation.py:1098-1126): per box, 2px-padded
// clamped crop, integer luma ((77r+150g+29b)>>8, no rounding — matches
// the numpy uint16 shift), 1-99 percentile contrast stretch via the
// 256-bin histogram (float32 scale, truncating cast), PIL-parity
// BILINEAR resize to (tile_h-4, new_w), white (tile_h, tile_w) tile
// with the content at rows [2, 2+target_h) and cols [0, new_w).
//
// src: RGB8 (h, w, 3) C-contiguous. boxes: n*4 int32 (x0,y0,x1,y1) in
// src coords — the caller applies any hires ratio scaling. out:
// caller-allocated n*tile_h*tile_w uint8. content_w: per-tile written
// width (new_w), for width-bucketed recognition batches.
void spdf_line_tiles(const uint8_t* src, int h, int w, const int* boxes,
                     int n, int tile_h, int tile_w, uint8_t* out,
                     int* content_w) {
  const int target_h = tile_h - 4;
  if (target_h <= 0 || tile_w <= 0) return;
  std::vector<uint8_t> gray, resized((size_t)target_h * tile_w);
  for (int i = 0; i < n; i++) {
    int x0 = boxes[i * 4], y0 = boxes[i * 4 + 1];
    int x1 = boxes[i * 4 + 2], y1 = boxes[i * 4 + 3];
    int yy0 = std::max(0, y0 - 2), xx0 = std::max(0, x0 - 2);
    int yy1 = std::min(h, y1 + 2), xx1 = std::min(w, x1 + 2);
    int sh = yy1 - yy0, sw = xx1 - xx0;
    int hist[256] = {0};
    if (sh <= 0 || sw <= 0) {
      sh = 8;
      sw = 8;
      gray.assign(64, 255);
      hist[255] = 64;
    } else {
      gray.resize((size_t)sh * sw);
      for (int y = 0; y < sh; y++) {
        const uint8_t* row = src + ((size_t)(yy0 + y) * w + xx0) * 3;
        uint8_t* grow = gray.data() + (size_t)y * sw;
        for (int x = 0; x < sw; x++) {
          const uint8_t* p = row + (size_t)x * 3;
          uint8_t g =
              (uint8_t)(((unsigned)(77 * p[0] + 150 * p[1] + 29 * p[2])) >> 8);
          grow[x] = g;
          hist[g]++;
        }
      }
    }
    // 1/99 percentiles: np.searchsorted(cumsum, q*n) left semantics
    const double n_px = (double)sh * sw;
    const double vlo = 0.01 * n_px, vhi = 0.99 * n_px;
    int lo = 256, hi = 256;
    long cum = 0;
    for (int b = 0; b < 256; b++) {
      cum += hist[b];
      if (lo == 256 && (double)cum >= vlo) lo = b;
      if (hi == 256 && (double)cum >= vhi) {
        hi = b;
        break;
      }
    }
    if ((double)hi - lo > 30.0) {
      // float32 per-op math, truncating cast — matches the numpy path
      const float flo = (float)(double)lo;
      const float mul = (float)(255.0 / ((double)hi - lo));
      for (auto& g : gray) {
        float v = ((float)g - flo) * mul;
        if (v < 0.0f) v = 0.0f;
        if (v > 255.0f) v = 255.0f;
        g = (uint8_t)v;
      }
    }
    const double scale_t = (double)target_h / std::max(sh, 1);
    int new_w = (int)(sw * scale_t);  // int() truncation
    new_w = std::max(1, std::min(new_w, tile_w));
    pil_resize_gray(gray.data(), sh, sw, resized.data(), target_h, new_w);
    uint8_t* tile = out + (size_t)i * tile_h * tile_w;
    memset(tile, 255, (size_t)tile_h * tile_w);
    for (int y = 0; y < target_h; y++)
      memcpy(tile + (size_t)(y + 2) * tile_w,
             resized.data() + (size_t)y * new_w, new_w);
    if (content_w) content_w[i] = new_w;
  }
}

void spdf_free(void* p) { free(p); }

}  // extern "C"
