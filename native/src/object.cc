// Object model, lexer, xref parsing, stream filters.
#include "spdf.h"

#include <zlib.h>

#include <algorithm>
#include <cmath>
#include <atomic>
#include <cstdio>
#include <cstring>

namespace spdf {

ObjPtr make_null() { return std::make_shared<Object>(); }
ObjPtr make_int(int64_t v) {
  auto o = std::make_shared<Object>();
  o->type = ObjType::Int;
  o->i = v;
  return o;
}
ObjPtr make_real(double v) {
  auto o = std::make_shared<Object>();
  o->type = ObjType::Real;
  o->r = v;
  return o;
}
ObjPtr make_name(const std::string& n) {
  auto o = std::make_shared<Object>();
  o->type = ObjType::Name;
  o->s = n;
  return o;
}

// ---------------------------------------------------------------------------
// Lexer
// ---------------------------------------------------------------------------

static inline bool is_ws(uint8_t c) {
  return c == ' ' || c == '\t' || c == '\r' || c == '\n' || c == '\f' ||
         c == '\0';
}
static inline bool is_delim(uint8_t c) {
  return c == '(' || c == ')' || c == '<' || c == '>' || c == '[' ||
         c == ']' || c == '{' || c == '}' || c == '/' || c == '%';
}

void Lexer::skip_ws() {
  while (p_ < n_) {
    if (is_ws(d_[p_])) {
      p_++;
    } else if (d_[p_] == '%') {  // comment to EOL
      while (p_ < n_ && d_[p_] != '\n' && d_[p_] != '\r') p_++;
    } else {
      break;
    }
  }
}

std::string Lexer::next_keyword() {
  skip_ws();
  std::string kw;
  while (p_ < n_ && !is_ws(d_[p_]) && !is_delim(d_[p_])) kw += (char)d_[p_++];
  return kw;
}

bool Lexer::peek_keyword(const char* kw) {
  size_t save = p_;
  std::string got = next_keyword();
  p_ = save;
  return got == kw;
}

ObjPtr Lexer::parse_object() {
  skip_ws();
  if (p_ >= n_) return make_null();
  uint8_t c = d_[p_];
  if (c == '<') {
    if (p_ + 1 < n_ && d_[p_ + 1] == '<') return parse_dict_or_stream();
    return parse_hex_string();
  }
  if (c == '(') return parse_string();
  if (c == '/') return parse_name();
  if (c == '[') return parse_array();
  if ((c >= '0' && c <= '9') || c == '+' || c == '-' || c == '.')
    return parse_number_or_ref();
  // keywords: true false null (or R handled in number path)
  std::string kw = next_keyword();
  auto o = std::make_shared<Object>();
  if (kw == "true") {
    o->type = ObjType::Bool;
    o->b = true;
  } else if (kw == "false") {
    o->type = ObjType::Bool;
    o->b = false;
  } else {
    o->type = ObjType::Null;
    if (kw.empty() && p_ < n_) p_++;  // skip stray delimiter, avoid stall
  }
  return o;
}

ObjPtr Lexer::parse_number_or_ref() {
  size_t start = p_;
  bool real = false;
  while (p_ < n_ && (isdigit(d_[p_]) || d_[p_] == '+' || d_[p_] == '-' ||
                     d_[p_] == '.')) {
    if (d_[p_] == '.') real = true;
    p_++;
  }
  std::string tok((const char*)d_ + start, p_ - start);
  if (real) return make_real(atof(tok.c_str()));
  int64_t v = atoll(tok.c_str());
  // lookahead for "gen R"
  size_t save = p_;
  skip_ws();
  size_t gs = p_;
  while (p_ < n_ && isdigit(d_[p_])) p_++;
  if (p_ > gs) {
    std::string gtok((const char*)d_ + gs, p_ - gs);
    skip_ws();
    if (p_ < n_ && d_[p_] == 'R' &&
        (p_ + 1 >= n_ || is_ws(d_[p_ + 1]) || is_delim(d_[p_ + 1]))) {
      p_++;
      auto o = std::make_shared<Object>();
      o->type = ObjType::Ref;
      o->ref_num = (int)v;
      o->ref_gen = atoi(gtok.c_str());
      return o;
    }
  }
  p_ = save;
  return make_int(v);
}

ObjPtr Lexer::parse_string() {
  p_++;  // (
  auto o = std::make_shared<Object>();
  o->type = ObjType::String;
  int depth = 1;
  while (p_ < n_) {
    uint8_t c = d_[p_++];
    if (c == '\\' && p_ < n_) {
      uint8_t e = d_[p_++];
      switch (e) {
        case 'n': o->s += '\n'; break;
        case 'r': o->s += '\r'; break;
        case 't': o->s += '\t'; break;
        case 'b': o->s += '\b'; break;
        case 'f': o->s += '\f'; break;
        case '(': o->s += '('; break;
        case ')': o->s += ')'; break;
        case '\\': o->s += '\\'; break;
        case '\r':
          if (p_ < n_ && d_[p_] == '\n') p_++;
          break;  // line continuation
        case '\n': break;
        default:
          if (e >= '0' && e <= '7') {  // octal
            int v = e - '0';
            for (int k = 0; k < 2 && p_ < n_ && d_[p_] >= '0' && d_[p_] <= '7';
                 k++)
              v = v * 8 + (d_[p_++] - '0');
            o->s += (char)v;
          } else {
            o->s += (char)e;
          }
      }
    } else if (c == '(') {
      depth++;
      o->s += '(';
    } else if (c == ')') {
      if (--depth == 0) break;
      o->s += ')';
    } else {
      o->s += (char)c;
    }
  }
  return o;
}

ObjPtr Lexer::parse_hex_string() {
  p_++;  // <
  auto o = std::make_shared<Object>();
  o->type = ObjType::String;
  int hi = -1;
  while (p_ < n_ && d_[p_] != '>') {
    uint8_t c = d_[p_++];
    int v = -1;
    if (c >= '0' && c <= '9') v = c - '0';
    else if (c >= 'a' && c <= 'f') v = c - 'a' + 10;
    else if (c >= 'A' && c <= 'F') v = c - 'A' + 10;
    else continue;
    if (hi < 0) hi = v;
    else {
      o->s += (char)((hi << 4) | v);
      hi = -1;
    }
  }
  if (hi >= 0) o->s += (char)(hi << 4);
  if (p_ < n_) p_++;  // >
  return o;
}

ObjPtr Lexer::parse_name() {
  p_++;  // /
  auto o = std::make_shared<Object>();
  o->type = ObjType::Name;
  while (p_ < n_ && !is_ws(d_[p_]) && !is_delim(d_[p_])) {
    uint8_t c = d_[p_++];
    if (c == '#' && p_ + 1 < n_) {
      auto hex = [](uint8_t h) -> int {
        if (h >= '0' && h <= '9') return h - '0';
        if (h >= 'a' && h <= 'f') return h - 'a' + 10;
        if (h >= 'A' && h <= 'F') return h - 'A' + 10;
        return -1;
      };
      int a = hex(d_[p_]), b = hex(d_[p_ + 1]);
      if (a >= 0 && b >= 0) {
        o->s += (char)((a << 4) | b);
        p_ += 2;
        continue;
      }
    }
    o->s += (char)c;
  }
  return o;
}

ObjPtr Lexer::parse_array() {
  p_++;  // [
  auto o = std::make_shared<Object>();
  o->type = ObjType::Array;
  while (true) {
    skip_ws();
    if (p_ >= n_) break;
    if (d_[p_] == ']') {
      p_++;
      break;
    }
    o->arr.push_back(parse_object());
  }
  return o;
}

ObjPtr Lexer::parse_dict_or_stream() {
  p_ += 2;  // <<
  auto o = std::make_shared<Object>();
  o->type = ObjType::Dict;
  while (true) {
    skip_ws();
    if (p_ >= n_) break;
    if (d_[p_] == '>' && p_ + 1 < n_ && d_[p_ + 1] == '>') {
      p_ += 2;
      break;
    }
    if (d_[p_] != '/') {  // malformed; bail
      p_++;
      continue;
    }
    ObjPtr key = parse_name();
    o->dict[key->s] = parse_object();
  }
  // stream?
  size_t save = p_;
  skip_ws();
  if (p_ + 6 <= n_ && memcmp(d_ + p_, "stream", 6) == 0) {
    p_ += 6;
    if (p_ < n_ && d_[p_] == '\r') p_++;
    if (p_ < n_ && d_[p_] == '\n') p_++;
    o->type = ObjType::Stream;
    // Length may be a ref — caller (Document) fixes up; here grab what we can
    auto it = o->dict.find("Length");
    size_t len = 0;
    bool have_len = false;
    if (it != o->dict.end() && it->second->is(ObjType::Int)) {
      len = (size_t)it->second->i;
      have_len = (p_ + len <= n_);
    }
    if (have_len) {
      o->stream_raw.assign((const char*)d_ + p_, len);
      p_ += len;
      // consume endstream
      skip_ws();
      if (p_ + 9 <= n_ && memcmp(d_ + p_, "endstream", 9) == 0) p_ += 9;
    } else {
      // search for endstream
      size_t q = p_;
      while (q + 9 <= n_ && memcmp(d_ + q, "endstream", 9) != 0) q++;
      size_t end = q;
      while (end > p_ && (d_[end - 1] == '\n' || d_[end - 1] == '\r')) end--;
      o->stream_raw.assign((const char*)d_ + p_, end - p_);
      p_ = std::min(q + 9, n_);
    }
  } else {
    p_ = save;
  }
  return o;
}

// ---------------------------------------------------------------------------
// Filters
// ---------------------------------------------------------------------------

// Per-stream decoded-size ceiling. No legitimate book stream comes
// close (a full-page 600-DPI RGB scan is ~100 MB); without it a
// crafted zlib/LZW bomb — especially cascaded [/Fl /Fl] filters —
// inflates a few KB into gigabytes and OOMs the host.
static const size_t kMaxDecodedStream = (size_t)256 << 20;

std::string flate_decode(const std::string& in) {
  std::string out;
  // clamp the upfront reserve at the ceiling: a cascaded [/Fl /Fl] bomb
  // whose inner stage decodes near kMaxDecodedStream would otherwise make
  // this line alone reserve ~4x the cap before the loop's guard runs
  out.reserve(std::min(in.size() * 4 + 64, kMaxDecodedStream));
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return out;
  zs.next_in = (Bytef*)in.data();
  zs.avail_in = (uInt)in.size();
  char buf[65536];
  int ret = Z_OK;
  do {
    if (out.size() >= kMaxDecodedStream) {
      // decompression bomb: drop HERE, inside the decoder — a payload
      // engineered to land exactly at the ceiling must not escape as a
      // "successful" 256MB decode the caller retains and lexes
      std::string().swap(out);
      break;
    }
    // cap capacity growth at the ceiling: unchecked doubling reallocs
    // 256MB -> 512MB with both buffers live, spiking peak RSS for a
    // stream that is about to be dropped anyway
    if (out.capacity() - out.size() < sizeof(buf))
      out.reserve(std::min(out.capacity() * 2 + sizeof(buf),
                           kMaxDecodedStream + sizeof(buf)));
    zs.next_out = (Bytef*)buf;
    zs.avail_out = sizeof(buf);
    ret = inflate(&zs, Z_NO_FLUSH);
    out.append(buf, sizeof(buf) - zs.avail_out);
  } while (ret == Z_OK);
  inflateEnd(&zs);
  return out;
}

std::string apply_png_predictor(const std::string& in, int colors, int bpc,
                                int columns) {
  int bpp = std::max(1, colors * bpc / 8);
  int rowlen = (columns * colors * bpc + 7) / 8;
  std::string out;
  std::vector<uint8_t> prev(rowlen, 0), cur(rowlen);
  size_t p = 0;
  while (p + 1 + rowlen <= in.size() + (size_t)rowlen) {
    if (p >= in.size()) break;
    uint8_t ft = in[p++];
    size_t take = std::min((size_t)rowlen, in.size() - p);
    memcpy(cur.data(), in.data() + p, take);
    if (take < (size_t)rowlen) memset(cur.data() + take, 0, rowlen - take);
    p += take;
    switch (ft) {
      case 0: break;
      case 1:
        for (int i = bpp; i < rowlen; i++) cur[i] += cur[i - bpp];
        break;
      case 2:
        for (int i = 0; i < rowlen; i++) cur[i] += prev[i];
        break;
      case 3:
        for (int i = 0; i < rowlen; i++) {
          int left = i >= bpp ? cur[i - bpp] : 0;
          cur[i] += (uint8_t)((left + prev[i]) / 2);
        }
        break;
      case 4:
        for (int i = 0; i < rowlen; i++) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          int b = prev[i];
          int c = i >= bpp ? prev[i - bpp] : 0;
          int pp = a + b - c;
          int pa = abs(pp - a), pb = abs(pp - b), pc = abs(pp - c);
          cur[i] += (uint8_t)(pa <= pb && pa <= pc ? a : (pb <= pc ? b : c));
        }
        break;
    }
    out.append((const char*)cur.data(), rowlen);
    prev = cur;
  }
  return out;
}

std::string ascii_hex_decode(const std::string& in) {
  std::string out;
  int hi = -1;
  for (char ch : in) {
    uint8_t c = (uint8_t)ch;
    if (c == '>') break;
    int v = -1;
    if (c >= '0' && c <= '9') v = c - '0';
    else if (c >= 'a' && c <= 'f') v = c - 'a' + 10;
    else if (c >= 'A' && c <= 'F') v = c - 'A' + 10;
    else continue;
    if (hi < 0) hi = v;
    else {
      out += (char)((hi << 4) | v);
      hi = -1;
    }
  }
  if (hi >= 0) out += (char)(hi << 4);
  return out;
}

std::string ascii85_decode(const std::string& in) {
  std::string out;
  uint32_t tup = 0;
  int cnt = 0;
  for (size_t i = 0; i < in.size(); i++) {
    uint8_t c = in[i];
    if (is_ws(c)) continue;
    if (c == '~') break;
    if (c == 'z' && cnt == 0) {
      out.append(4, '\0');
      if (out.size() >= kMaxDecodedStream) {  // 'z' bomb: 4x expansion
        std::string().swap(out);
        return out;
      }
      continue;
    }
    if (c < '!' || c > 'u') continue;
    tup = tup * 85 + (c - '!');
    if (++cnt == 5) {
      for (int k = 3; k >= 0; k--) out += (char)((tup >> (8 * k)) & 0xFF);
      tup = 0;
      cnt = 0;
    }
  }
  if (cnt > 0) {
    for (int k = cnt; k < 5; k++) tup = tup * 85 + 84;
    for (int k = 3; k >= 4 - (cnt - 1); k--)
      out += (char)((tup >> (8 * k)) & 0xFF);
  }
  return out;
}

std::string runlength_decode(const std::string& in) {
  std::string out;
  size_t p = 0;
  while (p < in.size()) {
    if (out.size() >= kMaxDecodedStream) {  // bomb: drop, don't truncate
      std::string().swap(out);
      break;
    }
    uint8_t l = in[p++];
    if (l == 128) break;
    if (l < 128) {
      size_t take = std::min((size_t)l + 1, in.size() - p);
      out.append(in, p, take);
      p += take;
    } else if (p < in.size()) {
      out.append(257 - l, in[p++]);
    }
  }
  return out;
}

std::string lzw_decode(const std::string& in, int early) {
  std::string out;
  std::vector<std::string> table;
  auto reset = [&]() {
    table.clear();
    for (int i = 0; i < 256; i++) table.push_back(std::string(1, (char)i));
    table.push_back("");  // 256 clear
    table.push_back("");  // 257 eod
  };
  reset();
  int bits = 9;
  uint32_t acc = 0;
  int nacc = 0;
  std::string prev;
  for (size_t i = 0; i < in.size(); i++) {
    acc = (acc << 8) | (uint8_t)in[i];
    nacc += 8;
    while (nacc >= bits) {
      int code = (acc >> (nacc - bits)) & ((1 << bits) - 1);
      nacc -= bits;
      if (code == 256) {
        reset();
        bits = 9;
        prev.clear();
        continue;
      }
      if (code == 257) return out;
      std::string entry;
      if (code < (int)table.size() && code != 256 && code != 257) {
        entry = table[code];
      } else if (!prev.empty()) {
        entry = prev + prev[0];
      }
      out += entry;
      if (out.size() >= kMaxDecodedStream) {  // LZW bomb: drop
        std::string().swap(out);
        return out;
      }
      if (!prev.empty()) table.push_back(prev + entry[0]);
      prev = entry;
      if ((int)table.size() + early >= (1 << bits) && bits < 12) bits++;
    }
  }
  return out;
}

// ---------------------------------------------------------------------------
// Document
// ---------------------------------------------------------------------------

bool Document::load(const std::string& path, const std::string& password) {
  password_ = password;
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) {
    err_ = "cannot open " + path;
    return false;
  }
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> bytes(sz);
  if (fread(bytes.data(), 1, sz, f) != (size_t)sz) {
    fclose(f);
    err_ = "short read";
    return false;
  }
  fclose(f);
  return load_bytes(std::move(bytes), password);
}

uint64_t Document::next_gen_id() {
  static std::atomic<uint64_t> counter{1};
  return counter.fetch_add(1, std::memory_order_relaxed);
}

bool Document::load_bytes(std::vector<uint8_t> bytes,
                          const std::string& password) {
  password_ = password;
  bytes_ = std::move(bytes);
  bool salvaged = false;
  if (!parse_xref()) {
    // salvage: brute-scan for "N G obj"
    if (!scan_all_objects()) return false;
    salvaged = true;
  }
  // must run BEFORE any content object is parsed (strings/streams decrypt
  // on parse), and AFTER the xref/trailer — crypto.cc
  setup_encryption();
  if (encrypted_ && file_key_.empty()) return false;  // unsupported scheme
  // The salvage Catalog probe parses+caches objects before the file key
  // exists; their strings would stay ciphertext forever (cache hits skip
  // decrypt_object). Drop those entries so they re-parse decrypted.
  if (salvaged && encrypted_) {
    cache_.clear();
    objstm_loaded_.clear();
  }
  return true;
}

bool Document::parse_xref() {
  // find startxref near EOF
  size_t n = bytes_.size();
  if (n < 20) {
    err_ = "too small";
    return false;
  }
  size_t tail = n > 2048 ? n - 2048 : 0;
  std::string tailstr((const char*)bytes_.data() + tail, n - tail);
  size_t sx = tailstr.rfind("startxref");
  if (sx == std::string::npos) {
    err_ = "no startxref";
    return false;
  }
  size_t pos = tail + sx + 9;
  Lexer lx(bytes_.data(), n, pos);
  ObjPtr off = lx.parse_object();
  if (!off->is(ObjType::Int)) {
    err_ = "bad startxref";
    return false;
  }
  std::vector<size_t> seen;
  return parse_xref_section((size_t)off->i, &seen, 0);
}

bool Document::parse_xref_section(size_t pos, std::vector<size_t>* seen,
                                  int depth) {
  if (depth > 32 || pos >= bytes_.size()) return false;
  for (size_t s : *seen)
    if (s == pos) return true;
  seen->push_back(pos);

  Lexer lx(bytes_.data(), bytes_.size(), pos);
  lx.skip_ws();
  if (lx.peek_keyword("xref")) {
    lx.next_keyword();
    // subsections
    while (true) {
      lx.skip_ws();
      if (lx.peek_keyword("trailer")) {
        lx.next_keyword();
        ObjPtr tr = lx.parse_object();
        if (!trailer_) trailer_ = tr;
        else {
          for (auto& kv : tr->dict)
            if (!trailer_->dict.count(kv.first)) trailer_->dict[kv.first] = kv.second;
        }
        auto prev = tr->dict.find("Prev");
        if (prev != tr->dict.end() && prev->second->is(ObjType::Int))
          parse_xref_section((size_t)prev->second->i, seen, depth + 1);
        auto xs = tr->dict.find("XRefStm");
        if (xs != tr->dict.end() && xs->second->is(ObjType::Int))
          parse_xref_section((size_t)xs->second->i, seen, depth + 1);
        return true;
      }
      ObjPtr start = lx.parse_object();
      ObjPtr count = lx.parse_object();
      if (!start->is(ObjType::Int) || !count->is(ObjType::Int)) return false;
      for (int64_t k = 0; k < count->i; k++) {
        lx.skip_ws();
        size_t p = lx.pos();
        if (p + 18 > bytes_.size()) return false;
        char ob[11] = {0}, gb[6] = {0};
        memcpy(ob, bytes_.data() + p, 10);
        memcpy(gb, bytes_.data() + p + 11, 5);
        char ty = bytes_[p + 17];
        lx.seek(p + 18);
        int num = (int)(start->i + k);
        if (!xref_.count(num)) {  // first-seen wins (newest first)
          XrefEntry e;
          e.offset = strtoull(ob, nullptr, 10);
          e.gen = atoi(gb);
          e.free_entry = (ty == 'f');
          xref_[num] = e;
        }
      }
    }
  }
  // else: xref stream — "N G obj << ... /Type /XRef ... >> stream"
  ObjPtr num = lx.parse_object();
  ObjPtr gen = lx.parse_object();
  (void)gen;
  std::string kw = lx.next_keyword();
  if (!num->is(ObjType::Int) || kw != "obj") {
    err_ = "bad xref section";
    return false;
  }
  ObjPtr stm = lx.parse_object();
  if (!stm->is(ObjType::Stream)) {
    err_ = "xref obj not stream";
    return false;
  }
  if (!trailer_) {
    trailer_ = std::make_shared<Object>();
    trailer_->type = ObjType::Dict;
  }
  for (auto& kv : stm->dict)
    if (!trailer_->dict.count(kv.first)) trailer_->dict[kv.first] = kv.second;
  if (!parse_xref_stream_obj(stm)) return false;
  auto prev = stm->dict.find("Prev");
  if (prev != stm->dict.end() && prev->second->is(ObjType::Int))
    parse_xref_section((size_t)prev->second->i, seen, depth + 1);
  return true;
}

bool Document::parse_xref_stream_obj(const ObjPtr& stm) {
  std::string data = decode_stream(stm);
  auto wobj = stm->dict.find("W");
  if (wobj == stm->dict.end() || !wobj->second->is(ObjType::Array))
    return false;
  std::vector<int> W;
  for (auto& w : wobj->second->arr) W.push_back((int)w->num());
  if (W.size() < 3) return false;
  int rowlen = W[0] + W[1] + W[2];
  std::vector<std::pair<int64_t, int64_t>> ranges;  // (start, count)
  auto idx = stm->dict.find("Index");
  if (idx != stm->dict.end() && idx->second->is(ObjType::Array)) {
    auto& a = idx->second->arr;
    for (size_t i = 0; i + 1 < a.size(); i += 2)
      ranges.push_back({(int64_t)a[i]->num(), (int64_t)a[i + 1]->num()});
  } else {
    auto sz = stm->dict.find("Size");
    int64_t size = sz != stm->dict.end() ? (int64_t)sz->second->num() : 0;
    ranges.push_back({0, size});
  }
  size_t p = 0;
  for (auto& rg : ranges) {
    for (int64_t k = 0; k < rg.second && p + rowlen <= data.size(); k++) {
      auto read_field = [&](int width) -> uint64_t {
        uint64_t v = 0;
        for (int b = 0; b < width; b++) v = (v << 8) | (uint8_t)data[p++];
        return v;
      };
      uint64_t t = W[0] ? read_field(W[0]) : 1;
      uint64_t f2 = read_field(W[1]);
      uint64_t f3 = W[2] ? read_field(W[2]) : 0;
      int onum = (int)(rg.first + k);
      if (xref_.count(onum)) continue;
      XrefEntry e;
      if (t == 0) {
        e.free_entry = true;
      } else if (t == 1) {
        e.free_entry = false;
        e.offset = f2;
        e.gen = (int)f3;
      } else if (t == 2) {
        e.free_entry = false;
        e.in_objstm = true;
        e.offset = f2;             // object stream number
        e.objstm_index = (uint32_t)f3;
      }
      xref_[onum] = e;
    }
  }
  return true;
}

bool Document::scan_all_objects() {
  // Brute-force: find every "<num> <gen> obj" occurrence.
  const uint8_t* d = bytes_.data();
  size_t n = bytes_.size();
  for (size_t p = 0; p + 4 < n; p++) {
    if (d[p] == 'o' && d[p + 1] == 'b' && d[p + 2] == 'j' &&
        (p + 3 >= n || is_ws(d[p + 3]) || is_delim(d[p + 3]))) {
      // walk back: ws gen ws num
      size_t q = p;
      while (q > 0 && is_ws(d[q - 1])) q--;
      size_t ge = q;
      while (q > 0 && isdigit(d[q - 1])) q--;
      size_t gs = q;
      if (gs == ge) continue;
      while (q > 0 && is_ws(d[q - 1])) q--;
      size_t ne = q;
      while (q > 0 && isdigit(d[q - 1])) q--;
      size_t ns = q;
      if (ns == ne) continue;
      int onum = atoi(std::string((const char*)d + ns, ne - ns).c_str());
      XrefEntry e;
      e.offset = ns;
      e.free_entry = false;
      xref_[onum] = e;  // last wins (later in file = newer)
    }
  }
  // find trailer dict or any /Root
  std::string all((const char*)d, std::min(n, (size_t)1 << 26));
  size_t tp = all.rfind("trailer");
  if (tp != std::string::npos) {
    Lexer lx(d, n, tp + 7);
    trailer_ = lx.parse_object();
  }
  if (!trailer_ || !trailer_->dict.count("Root")) {
    // look for an object with /Type /Catalog
    for (auto& kv : xref_) {
      ObjPtr o = get_object(kv.first);
      if (o && o->is(ObjType::Dict)) {
        auto t = o->dict.find("Type");
        if (t != o->dict.end() && t->second->s == "Catalog") {
          trailer_ = std::make_shared<Object>();
          trailer_->type = ObjType::Dict;
          auto r = std::make_shared<Object>();
          r->type = ObjType::Ref;
          r->ref_num = kv.first;
          trailer_->dict["Root"] = r;
          break;
        }
      }
    }
  }
  return trailer_ != nullptr;
}

ObjPtr Document::get_object(int num) {
  auto c = cache_.find(num);
  if (c != cache_.end()) return c->second;
  auto x = xref_.find(num);
  if (x == xref_.end() || x->second.free_entry) return make_null();
  if (x->second.in_objstm) {
    int stm_num = (int)x->second.offset;
    if (!objstm_loaded_[stm_num]) {
      load_object_stream(stm_num);
      objstm_loaded_[stm_num] = true;
    }
    auto c2 = cache_.find(num);
    return c2 != cache_.end() ? c2->second : make_null();
  }
  if (x->second.offset >= bytes_.size()) return make_null();
  Lexer lx(bytes_.data(), bytes_.size(), x->second.offset);
  ObjPtr n1 = lx.parse_object();
  ObjPtr g1 = lx.parse_object();
  (void)n1;
  int gen = g1->is(ObjType::Int) ? (int)g1->i : 0;
  std::string kw = lx.next_keyword();
  if (kw != "obj") return make_null();
  ObjPtr o = lx.parse_object();
  o->obj_num = num;
  o->obj_gen = gen;
  // standard security handler: strings decrypt at parse; streams at
  // decode_stream (the /Encrypt dict itself and objstm-contained
  // objects are exempt — the container stream was already decrypted)
  if (encrypted_ && num != encrypt_obj_num_)
    decrypt_object(o, num, gen);
  // fix up indirect /Length for streams
  if (o->is(ObjType::Stream)) {
    auto it = o->dict.find("Length");
    if (it != o->dict.end() && it->second->is(ObjType::Ref)) {
      ObjPtr len = get_object(it->second->ref_num);
      if (len->is(ObjType::Int)) {
        // re-read stream with correct length
        size_t sp = x->second.offset;
        std::string window((const char*)bytes_.data() + sp,
                           std::min(bytes_.size() - sp, (size_t)4096));
        size_t st = window.find("stream");
        if (st != std::string::npos) {
          size_t dp = sp + st + 6;
          if (dp < bytes_.size() && bytes_[dp] == '\r') dp++;
          if (dp < bytes_.size() && bytes_[dp] == '\n') dp++;
          size_t l = (size_t)len->i;
          if (dp + l <= bytes_.size())
            o->stream_raw.assign((const char*)bytes_.data() + dp, l);
        }
        o->dict["Length"] = len;
      }
    }
  }
  cache_[num] = o;
  return o;
}

void Document::load_object_stream(int num) {
  ObjPtr stm = get_object(num);
  if (!stm->is(ObjType::Stream)) return;
  std::string data = decode_stream(stm);
  int n = 0, first = 0;
  auto nn = stm->dict.find("N");
  auto ff = stm->dict.find("First");
  if (nn != stm->dict.end()) n = (int)resolve(nn->second)->num();
  if (ff != stm->dict.end()) first = (int)resolve(ff->second)->num();
  Lexer hdr((const uint8_t*)data.data(), data.size());
  std::vector<std::pair<int, size_t>> locs;
  for (int k = 0; k < n; k++) {
    ObjPtr onum = hdr.parse_object();
    ObjPtr ooff = hdr.parse_object();
    if (!onum->is(ObjType::Int) || !ooff->is(ObjType::Int)) break;
    locs.push_back({(int)onum->i, (size_t)(first + ooff->i)});
  }
  for (auto& lo : locs) {
    if (lo.second >= data.size()) continue;
    if (cache_.count(lo.first)) continue;
    Lexer lx((const uint8_t*)data.data(), data.size(), lo.second);
    cache_[lo.first] = lx.parse_object();
  }
}

ObjPtr Document::resolve(const ObjPtr& o) {
  ObjPtr cur = o;
  for (int guard = 0; guard < 32 && cur && cur->is(ObjType::Ref); guard++)
    cur = get_object(cur->ref_num);
  return cur ? cur : make_null();
}

ObjPtr Document::dict_get(const ObjPtr& dict, const std::string& key) {
  if (!dict || !(dict->is(ObjType::Dict) || dict->is(ObjType::Stream)))
    return make_null();
  auto it = dict->dict.find(key);
  if (it == dict->dict.end()) return make_null();
  return resolve(it->second);
}

std::string Document::decode_stream(const ObjPtr& stm) {
  if (!stm->is(ObjType::Stream)) return "";
  std::string data = stm->stream_raw;
  if (encrypted_ && stm->obj_num > 0 && stm->obj_num != encrypt_obj_num_) {
    auto t = stm->dict.find("Type");
    bool exempt = t != stm->dict.end() &&
                  (t->second->s == "XRef" ||
                   (!encrypt_metadata_ && t->second->s == "Metadata"));
    if (!exempt) data = decrypt_data(data, stm->obj_num, stm->obj_gen);
  }
  ObjPtr filter = dict_get(stm, "Filter");
  ObjPtr parms = dict_get(stm, "DecodeParms");
  if (parms->is(ObjType::Null)) parms = dict_get(stm, "DP");
  std::vector<ObjPtr> filters, parmlist;
  if (filter->is(ObjType::Name)) {
    filters.push_back(filter);
    parmlist.push_back(parms);
  } else if (filter->is(ObjType::Array)) {
    for (size_t i = 0; i < filter->arr.size(); i++) {
      filters.push_back(resolve(filter->arr[i]));
      if (parms->is(ObjType::Array) && i < parms->arr.size())
        parmlist.push_back(resolve(parms->arr[i]));
      else if (parms->is(ObjType::Dict) && i == 0)
        parmlist.push_back(parms);
      else
        parmlist.push_back(make_null());
    }
  }
  bool expanded = false;  // a decode stage (not raw passthrough) ran
  for (size_t i = 0; i <= filters.size(); i++) {
    // decompression-bomb guard: a decode stage that hit the per-stream
    // ceiling produced garbage (legit book streams stay far below it,
    // see kMaxDecodedStream) — drop it entirely rather than feed it to
    // the next stage (exponential blowup) or return a truncated
    // 256MB+ buffer callers would retain/lex. Raw data (unfiltered,
    // DCT/JPX passthrough) is bounded by the file size and kept.
    if (expanded && data.size() >= kMaxDecodedStream) {
      data.clear();
      data.shrink_to_fit();
      break;
    }
    if (i == filters.size()) break;
    const std::string& f = filters[i]->s;
    if (f == "FlateDecode" || f == "Fl" || f == "ASCIIHexDecode" ||
        f == "AHx" || f == "ASCII85Decode" || f == "A85" ||
        f == "RunLengthDecode" || f == "RL" || f == "LZWDecode" ||
        f == "LZW" || f == "CCITTFaxDecode" || f == "CCF")
      expanded = true;
    if (f == "FlateDecode" || f == "Fl") data = flate_decode(data);
    else if (f == "ASCIIHexDecode" || f == "AHx") data = ascii_hex_decode(data);
    else if (f == "ASCII85Decode" || f == "A85") data = ascii85_decode(data);
    else if (f == "RunLengthDecode" || f == "RL") data = runlength_decode(data);
    else if (f == "LZWDecode" || f == "LZW") {
      int early = 1;
      ObjPtr pm = parmlist[i];
      if (pm->is(ObjType::Dict)) {
        ObjPtr e = dict_get(pm, "EarlyChange");
        if (!e->is(ObjType::Null)) early = (int)e->num();
      }
      data = lzw_decode(data, early);
    } else if (f == "CCITTFaxDecode" || f == "CCF") {
      int k = 0, columns = 1728, rows = 0;
      bool black1 = false, align = false;
      ObjPtr pm = parmlist[i];
      if (pm->is(ObjType::Dict)) {
        ObjPtr kk = dict_get(pm, "K");
        if (!kk->is(ObjType::Null)) k = (int)kk->num();
        ObjPtr cc = dict_get(pm, "Columns");
        if (!cc->is(ObjType::Null)) columns = (int)cc->num();
        ObjPtr rr = dict_get(pm, "Rows");
        if (!rr->is(ObjType::Null)) rows = (int)rr->num();
        ObjPtr b1 = dict_get(pm, "BlackIs1");
        if (b1->is(ObjType::Bool)) black1 = b1->b;
        ObjPtr ba = dict_get(pm, "EncodedByteAlign");
        if (ba->is(ObjType::Bool)) align = ba->b;
      }
      if (rows == 0) {
        ObjPtr hh = dict_get(stm, "Height");
        if (!hh->is(ObjType::Null)) rows = (int)hh->num();
      }
      data = ccitt_decode(data, k, columns, rows, black1, align);
      continue;  // no predictor pass for fax data
    } else {
      // DCTDecode/JPXDecode stay raw (image decoder handles DCT)
      continue;
    }
    ObjPtr pm = parmlist[i];
    if (pm->is(ObjType::Dict)) {
      ObjPtr pred = dict_get(pm, "Predictor");
      if (pred->num() >= 10) {
        int colors = 1, bpc = 8, cols = 1;
        ObjPtr c = dict_get(pm, "Colors");
        ObjPtr b = dict_get(pm, "BitsPerComponent");
        ObjPtr k = dict_get(pm, "Columns");
        if (!c->is(ObjType::Null)) colors = (int)c->num();
        if (!b->is(ObjType::Null)) bpc = (int)b->num();
        if (!k->is(ObjType::Null)) cols = (int)k->num();
        data = apply_png_predictor(data, colors, bpc, cols);
      } else if (pred->num() == 2) {
        // TIFF predictor (rare) — apply per-component delta
        int colors = (int)std::max(1.0, dict_get(pm, "Colors")->num());
        int cols = (int)std::max(1.0, dict_get(pm, "Columns")->num());
        int rowlen = cols * colors;
        for (size_t r = 0; r + rowlen <= data.size(); r += rowlen)
          for (int ii = colors; ii < rowlen; ii++)
            data[r + ii] = (char)((uint8_t)data[r + ii] +
                                  (uint8_t)data[r + ii - colors]);
      }
    }
  }
  return data;
}

void Document::collect_pages(const ObjPtr& node, int depth) {
  if (depth > 64) return;
  ObjPtr n = resolve(node);
  if (!n->is(ObjType::Dict)) return;
  ObjPtr type = dict_get(n, "Type");
  if (type->s == "Page") {
    pages_.push_back(n);
    return;
  }
  ObjPtr kids = dict_get(n, "Kids");
  if (kids->is(ObjType::Array)) {
    for (auto& k : kids->arr) {
      ObjPtr kid = resolve(k);
      // stash parent link for inherited attributes
      if (kid->is(ObjType::Dict) && !kid->dict.count("__parent__"))
        kid->dict["__parent__"] = n;
      collect_pages(kid, depth + 1);
    }
  }
}

int Document::page_count() {
  if (!pages_collected_) {
    ObjPtr root = dict_get(trailer_, "Root");
    ObjPtr ptree = dict_get(root, "Pages");
    collect_pages(ptree, 0);
    pages_collected_ = true;
  }
  return (int)pages_.size();
}

ObjPtr Document::page(int index) {
  page_count();
  if (index < 0 || index >= (int)pages_.size()) return make_null();
  return pages_[index];
}

ObjPtr Document::page_inherited(const ObjPtr& pg, const std::string& key) {
  ObjPtr cur = pg;
  for (int guard = 0; guard < 64 && cur->is(ObjType::Dict); guard++) {
    auto it = cur->dict.find(key);
    if (it != cur->dict.end()) return resolve(it->second);
    auto pit = cur->dict.find("__parent__");
    if (pit == cur->dict.end()) {
      auto pr = cur->dict.find("Parent");
      if (pr == cur->dict.end()) break;
      cur = resolve(pr->second);
      continue;
    }
    cur = pit->second;
  }
  return make_null();
}

int Document::page_rotation(int index) {
  // inheritable /Rotate, normalized to {0, 90, 180, 270}
  ObjPtr pg = page(index);
  ObjPtr rot = page_inherited(pg, "Rotate");
  if (rot->is(ObjType::Null)) return 0;
  long r = (long)rot->num() % 360;
  if (r < 0) r += 360;
  return (r == 90 || r == 180 || r == 270) ? (int)r : 0;
}

// normalized [x0, y0, x1, y1] of an inheritable box entry, or false
static bool read_box(Document* doc, const ObjPtr& pg, const char* key,
                     double out[4]) {
  ObjPtr b = doc->page_inherited(pg, key);
  if (!b->is(ObjType::Array) || b->arr.size() != 4) return false;
  double xa = doc->resolve(b->arr[0])->num(), ya = doc->resolve(b->arr[1])->num();
  double xb = doc->resolve(b->arr[2])->num(), yb = doc->resolve(b->arr[3])->num();
  // the spec allows corners in any order (real generators do emit
  // inverted boxes); readers normalize — so does fitz (ref :2731)
  out[0] = std::min(xa, xb);
  out[1] = std::min(ya, yb);
  out[2] = std::max(xa, xb);
  out[3] = std::max(ya, yb);
  for (int i = 0; i < 4; i++)
    if (!std::isfinite(out[i])) return false;
  return out[2] > out[0] && out[3] > out[1];
}

void Document::page_box(int index, double* x0, double* y0,
                        double* w, double* h) {
  // effective UNROTATED page box: CropBox intersected with MediaBox
  // (fitz displays the CropBox — print-grade books put crop marks in
  // the MediaBox margin outside it), US Letter when both are absent
  *x0 = 0;
  *y0 = 0;
  *w = 612;
  *h = 792;
  ObjPtr pg = page(index);
  double mb[4];
  bool have_mb = read_box(this, pg, "MediaBox", mb);
  if (have_mb) {
    *x0 = mb[0];
    *y0 = mb[1];
    *w = mb[2] - mb[0];
    *h = mb[3] - mb[1];
  }
  double cb[4];
  if (read_box(this, pg, "CropBox", cb)) {
    if (have_mb) {  // intersect with the media box
      cb[0] = std::max(cb[0], mb[0]);
      cb[1] = std::max(cb[1], mb[1]);
      cb[2] = std::min(cb[2], mb[2]);
      cb[3] = std::min(cb[3], mb[3]);
    }
    if (cb[2] > cb[0] && cb[3] > cb[1]) {
      *x0 = cb[0];
      *y0 = cb[1];
      *w = cb[2] - cb[0];
      *h = cb[3] - cb[1];
    }
  }
}

void Document::page_extent(int index, double* w, double* h) {
  double x0, y0;
  page_box(index, &x0, &y0, w, h);
}

void Document::page_size(int index, double* w, double* h) {
  // DISPLAY size: /Rotate 90/270 swaps the extent, like fitz page.rect
  page_extent(index, w, h);
  int r = page_rotation(index);
  if (r == 90 || r == 270) std::swap(*w, *h);
}

}  // namespace spdf
