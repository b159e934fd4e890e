// Content-stream interpreter: text spans + drawing bboxes + image placements
// (the fitz get_text("dict") / get_drawings / get_image_rects equivalents,
// ref pdf_image_segmentation.py:3154, 3274, 3290), plus a display list the
// rasterizer replays at any scale.
#include "spdf.h"

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdlib>
#include <cstring>

namespace spdf {

JpxDecodeCb g_jpx_decode_cb = nullptr;

// Non-embedded fonts substitute DejaVu. Sans and Sans-Bold ship with the
// package (the binding sets g_font_dir); Serif and Mono come from the
// system's DejaVu install when present, else Sans stands in.
std::string g_font_dir;
static const char* kSystemFontDir = "/usr/share/fonts/truetype/dejavu/";

static std::string font_path(const char* name) {
  std::string own = g_font_dir + "/" + name;
  if (!g_font_dir.empty()) {
    if (FILE* f = fopen(own.c_str(), "rb")) {
      fclose(f);
      return own;
    }
  }
  std::string sys = std::string(kSystemFontDir) + name;
  if (FILE* f = fopen(sys.c_str(), "rb")) {
    fclose(f);
    return sys;
  }
  return g_font_dir + "/DejaVuSans.ttf";
}

static std::shared_ptr<TrueTypeFont> load_substitute(const std::string& base) {
  static std::unordered_map<std::string, std::shared_ptr<TrueTypeFont>> cache;
  std::string lower;
  for (char c : base) lower += (char)tolower(c);
  const char* name = "DejaVuSans.ttf";
  if (lower.find("mono") != std::string::npos ||
      lower.find("courier") != std::string::npos)
    name = "DejaVuSansMono.ttf";
  else if (lower.find("times") != std::string::npos ||
           lower.find("serif") != std::string::npos ||
           lower.find("roman") != std::string::npos)
    name = "DejaVuSerif.ttf";
  else if (lower.find("bold") != std::string::npos)
    name = "DejaVuSans-Bold.ttf";
  std::string spath = font_path(name);
  const char* path = spath.c_str();
  auto it = cache.find(path);
  if (it != cache.end()) return it->second;
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string data(sz, 0);
  size_t got = fread(&data[0], 1, sz, f);
  fclose(f);
  if (got != (size_t)sz) return nullptr;
  auto ttf = std::make_shared<TrueTypeFont>();
  if (!ttf->load(std::move(data))) return nullptr;
  cache[path] = ttf;
  return ttf;
}

// ---------------------------------------------------------------------------
// ToUnicode CMap (bfchar / bfrange)
// ---------------------------------------------------------------------------

static uint32_t hexstr_to_code(const std::string& s) {
  uint32_t v = 0;
  for (uint8_t c : s) v = (v << 8) | c;
  return v;
}

static void parse_tounicode(const std::string& cmap, PdfFont* font) {
  Lexer lx((const uint8_t*)cmap.data(), cmap.size());
  std::vector<ObjPtr> stack;
  while (!lx.eof()) {
    lx.skip_ws();
    if (lx.eof()) break;
    uint8_t c = ((const uint8_t*)cmap.data())[lx.pos()];
    if (c == '<' || c == '[' || c == '(' || c == '/' ||
        (c >= '0' && c <= '9') || c == '+' || c == '-' || c == '.') {
      stack.push_back(lx.parse_object());
      if (stack.size() > 64) stack.erase(stack.begin(), stack.begin() + 32);
      continue;
    }
    std::string kw = lx.next_keyword();
    if (kw.empty()) {
      // stray delimiter (corrupt CMap): next_keyword() returns empty
      // WITHOUT consuming — skip the byte or this loop never advances
      // (fuzz finding: infinite loop on mutated ToUnicode streams)
      lx.seek(lx.pos() + 1);
      continue;
    }
    if (kw == "endbfchar" || kw == "endbfrange" || kw == "endcodespacerange") {
      stack.clear();
      continue;
    }
    if (kw == "beginbfchar") {
      while (true) {
        lx.skip_ws();
        if (lx.eof() || lx.peek_keyword("endbfchar")) break;
        ObjPtr src = lx.parse_object();
        ObjPtr dst = lx.parse_object();
        if (!src->is(ObjType::String) || !dst->is(ObjType::String)) break;
        uint32_t code = hexstr_to_code(src->s);
        // dst is UTF-16BE; take first unit (surrogates rare in books)
        if (dst->s.size() >= 2)
          font->to_unicode[code] =
              ((uint8_t)dst->s[0] << 8) | (uint8_t)dst->s[1];
      }
    } else if (kw == "beginbfrange") {
      while (true) {
        lx.skip_ws();
        if (lx.eof() || lx.peek_keyword("endbfrange")) break;
        ObjPtr lo = lx.parse_object();
        ObjPtr hi = lx.parse_object();
        ObjPtr dst = lx.parse_object();
        if (!lo->is(ObjType::String) || !hi->is(ObjType::String)) break;
        uint32_t a = hexstr_to_code(lo->s), b = hexstr_to_code(hi->s);
        if (b - a > 65535) break;
        if (dst->is(ObjType::String)) {
          uint32_t u = 0;
          if (dst->s.size() >= 2)
            u = ((uint8_t)dst->s[dst->s.size() - 2] << 8) |
                (uint8_t)dst->s[dst->s.size() - 1];
          for (uint32_t k = a; k <= b; k++) font->to_unicode[k] = u + (k - a);
        } else if (dst->is(ObjType::Array)) {
          for (uint32_t k = a; k <= b && k - a < dst->arr.size(); k++) {
            const std::string& ds = dst->arr[k - a]->s;
            if (ds.size() >= 2)
              font->to_unicode[k] =
                  ((uint8_t)ds[0] << 8) | (uint8_t)ds[1];
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// PDF font loading
// ---------------------------------------------------------------------------

static std::shared_ptr<PdfFont> load_font(Document* doc, const ObjPtr& fdict) {
  auto font = std::make_shared<PdfFont>();
  ObjPtr subtype = doc->dict_get(fdict, "Subtype");
  ObjPtr base = doc->dict_get(fdict, "BaseFont");
  font->base_font = base->s;
  ObjPtr actual = fdict;
  if (subtype->s == "Type0") {
    font->is_cid = true;
    font->two_byte = true;  // Identity-H assumption
    ObjPtr desc = doc->dict_get(fdict, "DescendantFonts");
    if (desc->is(ObjType::Array) && !desc->arr.empty())
      actual = doc->resolve(desc->arr[0]);
    // /W widths
    ObjPtr W = doc->dict_get(actual, "W");
    ObjPtr dw = doc->dict_get(actual, "DW");
    font->default_width = dw->is(ObjType::Null) ? 1000 : dw->num();
    if (W->is(ObjType::Array)) {
      size_t i = 0;
      while (i < W->arr.size()) {
        int c0 = (int)doc->resolve(W->arr[i++])->num();
        if (i >= W->arr.size()) break;
        ObjPtr second = doc->resolve(W->arr[i++]);
        if (second->is(ObjType::Array)) {
          for (size_t k = 0; k < second->arr.size(); k++)
            font->widths[c0 + (uint32_t)k] = doc->resolve(second->arr[k])->num();
        } else {
          int c1 = (int)second->num();
          if (i >= W->arr.size()) break;
          double w = doc->resolve(W->arr[i++])->num();
          for (int c = c0; c <= c1 && c - c0 < 65536; c++) font->widths[c] = w;
        }
      }
    }
  } else {
    ObjPtr fc = doc->dict_get(fdict, "FirstChar");
    ObjPtr widths = doc->dict_get(fdict, "Widths");
    if (widths->is(ObjType::Array)) {
      int first = (int)fc->num();
      for (size_t k = 0; k < widths->arr.size(); k++) {
        double w = doc->resolve(widths->arr[k])->num();
        if (w > 0) font->widths[first + (uint32_t)k] = w;
      }
    }
    ObjPtr enc = doc->dict_get(fdict, "Encoding");
    if (enc->is(ObjType::Name)) {
      font->encoding = enc->s;
    } else if (enc->is(ObjType::Dict)) {
      ObjPtr basee = doc->dict_get(enc, "BaseEncoding");
      font->encoding = basee->s;
      ObjPtr diff = doc->dict_get(enc, "Differences");
      if (diff->is(ObjType::Array)) {
        int code = 0;
        for (auto& e : diff->arr) {
          ObjPtr r = doc->resolve(e);
          if (r->is(ObjType::Int)) code = (int)r->i;
          else if (r->is(ObjType::Name)) font->differences[code++] = r->s;
        }
      }
    }
  }
  if (subtype->s == "Type3") {
    // Type3: glyphs are content streams keyed by Encoding/Differences
    // names into /CharProcs; FontMatrix maps glyph -> text space.
    font->is_type3 = true;
    ObjPtr fm = doc->dict_get(fdict, "FontMatrix");
    if (fm->is(ObjType::Array) && fm->arr.size() == 6)
      font->t3_matrix = Matrix{doc->resolve(fm->arr[0])->num(),
                               doc->resolve(fm->arr[1])->num(),
                               doc->resolve(fm->arr[2])->num(),
                               doc->resolve(fm->arr[3])->num(),
                               doc->resolve(fm->arr[4])->num(),
                               doc->resolve(fm->arr[5])->num()};
    // /Widths are glyph-space: fold the matrix x-scale into the /1000
    // text-space convention the advance code uses
    double sx = std::sqrt(font->t3_matrix.a * font->t3_matrix.a +
                          font->t3_matrix.b * font->t3_matrix.b);
    for (auto& kv : font->widths) kv.second *= sx * 1000.0;
    font->default_width = 0;
    ObjPtr cp = doc->dict_get(fdict, "CharProcs");
    if (cp->is(ObjType::Dict)) {
      for (auto& kv : font->differences) {
        ObjPtr pr = doc->dict_get(cp, kv.second);
        if (pr->is(ObjType::Stream)) font->t3_procs[kv.first] = pr;
      }
    }
    font->t3_resources = doc->dict_get(fdict, "Resources");
  }
  // ToUnicode
  ObjPtr tu = doc->dict_get(fdict, "ToUnicode");
  if (tu->is(ObjType::Stream)) parse_tounicode(doc->decode_stream(tu), font.get());
  // embedded font file
  ObjPtr fd = doc->dict_get(actual, "FontDescriptor");
  if (fd->is(ObjType::Dict)) {
    ObjPtr flags = doc->dict_get(fd, "Flags");
    if (!flags->is(ObjType::Null) && ((int)flags->num() & 4))
      font->symbolic_cmap = true;
    ObjPtr ff2 = doc->dict_get(fd, "FontFile2");
    if (ff2->is(ObjType::Stream)) {
      auto ttf = std::make_shared<TrueTypeFont>();
      if (ttf->load(doc->decode_stream(ff2))) font->ttf = ttf;
    }
    if (!font->ttf) {
      // FontFile3: bare CFF (/Type1C, /CIDFontType0C) or OTTO OpenType
      ObjPtr ff3 = doc->dict_get(fd, "FontFile3");
      if (ff3->is(ObjType::Stream)) {
        std::string data = doc->decode_stream(ff3);
        auto cff = std::make_shared<CFFFont>();
        bool ok = data.size() > 4 && memcmp(data.data(), "OTTO", 4) == 0
                      ? cff->load_otf(data)
                      : cff->load(std::move(data));
        if (ok) font->ttf = cff;
      }
    }
    if (!font->ttf) {
      // FontFile: Type1 (PFA/PFB, eexec)
      ObjPtr ff1 = doc->dict_get(fd, "FontFile");
      if (ff1->is(ObjType::Stream)) {
        auto t1 = std::make_shared<Type1Font>();
        if (t1->load(doc->decode_stream(ff1))) font->ttf = t1;
      }
    }
  }
  // Type3 glyphs come from CharProcs; a name-based substitute outline
  // would render arbitrary wrong shapes for their private glyph names
  if (!font->ttf && !font->is_type3)
    font->ttf = load_substitute(font->base_font);
  // CIDToGIDMap stream
  if (font->is_cid) {
    ObjPtr c2g = doc->dict_get(actual, "CIDToGIDMap");
    if (c2g->is(ObjType::Stream)) {
      std::string m = doc->decode_stream(c2g);
      for (size_t k = 0; k + 1 < m.size(); k += 2)
        font->code_to_gid[(uint32_t)k / 2] =
            ((uint8_t)m[k] << 8) | (uint8_t)m[k + 1];
    }
  }
  return font;
}

// ---------------------------------------------------------------------------
// interpreter
// ---------------------------------------------------------------------------

namespace {

// ---------------------------------------------------------------------------
// Shadings (ShadingType 2 axial / 3 radial): PDF Function evaluation
// sampled into a 256-entry LUT at extraction time. Covers the `sh`
// operator and PatternType-2 pattern fills (gradient-filled chart bars
// etc.). Function types 0 (sampled) / 2 (exponential) / 3 (stitching)
// plus arrays of per-component functions.
// ---------------------------------------------------------------------------

// --- Type 4 (PostScript calculator) functions: a tiny tokenizer +
// stack evaluator covering the PDF subset (arithmetic, comparison,
// stack ops, if/ifelse). Programs are sampled 256x into the LUT like
// every other function type.
struct PsTok {
  enum Kind { Num, Op, Proc } kind = Num;
  double num = 0;
  std::string op;
  std::vector<PsTok> proc;
};

static bool ps_parse(const std::string& s, size_t* p, std::vector<PsTok>* out,
                     int depth) {
  if (depth > 16) return false;
  while (*p < s.size()) {
    char c = s[*p];
    if (isspace((unsigned char)c)) {
      (*p)++;
    } else if (c == '{') {
      (*p)++;
      PsTok t;
      t.kind = PsTok::Proc;
      if (!ps_parse(s, p, &t.proc, depth + 1)) return false;
      out->push_back(std::move(t));
    } else if (c == '}') {
      (*p)++;
      return true;
    } else if (c == '-' || c == '.' || isdigit((unsigned char)c)) {
      size_t q = *p + 1;
      while (q < s.size() && (isdigit((unsigned char)s[q]) || s[q] == '.' ||
                              s[q] == 'e' || s[q] == 'E' || s[q] == '-'))
        q++;
      PsTok t;
      t.kind = PsTok::Num;
      t.num = atof(s.substr(*p, q - *p).c_str());
      out->push_back(std::move(t));
      *p = q;
    } else if (isalpha((unsigned char)c)) {
      size_t q = *p;
      while (q < s.size() && isalpha((unsigned char)s[q])) q++;
      PsTok t;
      t.kind = PsTok::Op;
      t.op = s.substr(*p, q - *p);
      out->push_back(std::move(t));
      *p = q;
    } else {
      (*p)++;  // unknown byte: skip
    }
  }
  return depth == 0;
}

static bool ps_exec(const std::vector<PsTok>& prog, std::vector<double>* st,
                    int* steps) {
  for (const auto& t : prog) {
    if (++(*steps) > 20000 || st->size() > 256) return false;
    if (t.kind == PsTok::Num) {
      st->push_back(t.num);
      continue;
    }
    if (t.kind == PsTok::Proc) {
      // procedures are consumed by a following if/ifelse; represent the
      // block by its index pushed lazily — handled below via lookahead
      continue;  // placeholder; if/ifelse handled with explicit scan
    }
    const std::string& o = t.op;
    auto pop = [&]() {
      double v = st->empty() ? 0.0 : st->back();
      if (!st->empty()) st->pop_back();
      return v;
    };
    if (o == "add") { double b = pop(), a = pop(); st->push_back(a + b); }
    else if (o == "sub") { double b = pop(), a = pop(); st->push_back(a - b); }
    else if (o == "mul") { double b = pop(), a = pop(); st->push_back(a * b); }
    else if (o == "div") { double b = pop(), a = pop(); st->push_back(b != 0 ? a / b : 0); }
    else if (o == "idiv") { double b = pop(), a = pop(); st->push_back(b != 0 ? (double)((long)a / (long)b) : 0); }
    else if (o == "mod") { double b = pop(), a = pop(); st->push_back(b != 0 ? (double)((long)a % (long)b) : 0); }
    else if (o == "neg") { st->push_back(-pop()); }
    else if (o == "abs") { st->push_back(std::fabs(pop())); }
    else if (o == "ceiling") { st->push_back(std::ceil(pop())); }
    else if (o == "floor") { st->push_back(std::floor(pop())); }
    else if (o == "round") { st->push_back(std::round(pop())); }
    else if (o == "truncate") { st->push_back(std::trunc(pop())); }
    else if (o == "sqrt") { st->push_back(std::sqrt(std::max(0.0, pop()))); }
    else if (o == "sin") { st->push_back(std::sin(pop() * M_PI / 180.0)); }
    else if (o == "cos") { st->push_back(std::cos(pop() * M_PI / 180.0)); }
    else if (o == "atan") { double b = pop(), a = pop(); double d = std::atan2(a, b) * 180.0 / M_PI; if (d < 0) d += 360; st->push_back(d); }
    else if (o == "exp") { double b = pop(), a = pop(); st->push_back(std::pow(a, b)); }
    else if (o == "ln") { st->push_back(std::log(std::max(1e-300, pop()))); }
    else if (o == "log") { st->push_back(std::log10(std::max(1e-300, pop()))); }
    else if (o == "cvi") { st->push_back(std::trunc(pop())); }
    else if (o == "cvr") { /* no-op: all values are reals */ }
    else if (o == "dup") { double a = pop(); st->push_back(a); st->push_back(a); }
    else if (o == "pop") { pop(); }
    else if (o == "exch") { double b = pop(), a = pop(); st->push_back(b); st->push_back(a); }
    else if (o == "copy") {
      int n = (int)pop();
      if (n < 0 || (size_t)n > st->size() || st->size() + n > 256) return false;
      size_t base = st->size() - n;
      for (int i = 0; i < n; i++) st->push_back((*st)[base + i]);
    } else if (o == "index") {
      int n = (int)pop();
      if (n < 0 || (size_t)n >= st->size()) return false;
      st->push_back((*st)[st->size() - 1 - n]);
    } else if (o == "roll") {
      int j = (int)pop(), n = (int)pop();
      if (n < 0 || (size_t)n > st->size()) return false;
      if (n > 0 && j != 0) {
        size_t base = st->size() - n;
        int k = ((j % n) + n) % n;
        std::rotate(st->begin() + base, st->begin() + base + (n - k),
                    st->end());
      }
    }
    else if (o == "eq") { double b = pop(), a = pop(); st->push_back(a == b); }
    else if (o == "ne") { double b = pop(), a = pop(); st->push_back(a != b); }
    else if (o == "gt") { double b = pop(), a = pop(); st->push_back(a > b); }
    else if (o == "ge") { double b = pop(), a = pop(); st->push_back(a >= b); }
    else if (o == "lt") { double b = pop(), a = pop(); st->push_back(a < b); }
    else if (o == "le") { double b = pop(), a = pop(); st->push_back(a <= b); }
    else if (o == "and") { long b = (long)pop(), a = (long)pop(); st->push_back((double)(a & b)); }
    else if (o == "or") { long b = (long)pop(), a = (long)pop(); st->push_back((double)(a | b)); }
    else if (o == "xor") { long b = (long)pop(), a = (long)pop(); st->push_back((double)(a ^ b)); }
    else if (o == "not") { double a = pop(); st->push_back(a == 0 ? 1 : 0); }
    else if (o == "bitshift") { long b = (long)pop(), a = (long)pop(); st->push_back((double)(b >= 0 ? a << (b & 63) : a >> ((-b) & 63))); }
    else if (o == "true") { st->push_back(1); }
    else if (o == "false") { st->push_back(0); }
    else return false;  // unknown operator
  }
  return true;
}

// execute with if/ifelse support: procedures bind to the next
// conditional operator, so run a pre-pass pairing them
static bool ps_run(const std::vector<PsTok>& prog, std::vector<double>* st,
                   int* steps, int depth = 0) {
  if (depth > 32) return false;
  for (size_t i = 0; i < prog.size(); i++) {
    const PsTok& t = prog[i];
    if (t.kind == PsTok::Proc) {
      // look ahead: {p} if   |   {p1} {p2} ifelse
      if (i + 1 < prog.size() && prog[i + 1].kind == PsTok::Op &&
          prog[i + 1].op == "if") {
        double c = st->empty() ? 0 : st->back();
        if (!st->empty()) st->pop_back();
        if (c != 0 && !ps_run(t.proc, st, steps, depth + 1)) return false;
        i++;
        continue;
      }
      if (i + 2 < prog.size() && prog[i + 1].kind == PsTok::Proc &&
          prog[i + 2].kind == PsTok::Op && prog[i + 2].op == "ifelse") {
        double c = st->empty() ? 0 : st->back();
        if (!st->empty()) st->pop_back();
        const PsTok& br = c != 0 ? t : prog[i + 1];
        if (!ps_run(br.proc, st, steps, depth + 1)) return false;
        i += 2;
        continue;
      }
      return false;  // stray procedure
    }
    std::vector<PsTok> one{t};
    if (!ps_exec(one, st, steps)) return false;
  }
  return true;
}

static bool eval_pdf_function_n(Document* doc, const ObjPtr& fnin,
                                const std::vector<double>& xs,
                                std::vector<double>* out, int depth = 0);

// 1-input convenience wrapper (axial/radial shadings, Separation tints)
static bool eval_pdf_function(Document* doc, const ObjPtr& fnin, double x,
                              std::vector<double>* out, int depth = 0) {
  return eval_pdf_function_n(doc, fnin, {x}, out, depth);
}

static bool eval_pdf_function_n(Document* doc, const ObjPtr& fnin,
                                const std::vector<double>& xs_in,
                                std::vector<double>* out, int depth) {
  if (depth > 8 || xs_in.empty() || xs_in.size() > 4) return false;
  ObjPtr fn = doc->resolve(fnin);
  if (fn->is(ObjType::Array)) {  // one single-output function per component
    for (auto& el : fn->arr)
      if (!eval_pdf_function_n(doc, el, xs_in, out, depth + 1)) return false;
    return true;
  }
  std::vector<double> xs = xs_in;
  double x = xs[0];
  if (!fn->is(ObjType::Dict) && !fn->is(ObjType::Stream)) return false;
  int ft = (int)doc->dict_get(fn, "FunctionType")->num();
  double d0 = 0, d1 = 1;
  ObjPtr dom = doc->dict_get(fn, "Domain");
  if (dom->is(ObjType::Array) && dom->arr.size() >= 2) {
    d0 = doc->resolve(dom->arr[0])->num();
    d1 = doc->resolve(dom->arr[1])->num();
    for (size_t k = 0; k < xs.size(); k++) {
      if (2 * k + 1 < dom->arr.size()) {
        double lo = doc->resolve(dom->arr[2 * k])->num();
        double hi = doc->resolve(dom->arr[2 * k + 1])->num();
        xs[k] = std::min(std::max(xs[k], std::min(lo, hi)),
                         std::max(lo, hi));
      }
    }
  }
  x = std::min(std::max(x, std::min(d0, d1)), std::max(d0, d1));

  auto arr_at = [&](const ObjPtr& a, size_t i, double def) {
    if (a->is(ObjType::Array) && i < a->arr.size())
      return doc->resolve(a->arr[i])->num();
    return def;
  };

  if (ft == 2) {  // exponential interpolation C0 + x^N (C1 - C0)
    ObjPtr c0 = doc->dict_get(fn, "C0"), c1 = doc->dict_get(fn, "C1");
    ObjPtr N = doc->dict_get(fn, "N");
    double n = N->is(ObjType::Null) ? 1.0 : N->num();
    size_t m = 1;
    if (c0->is(ObjType::Array)) m = std::max(m, c0->arr.size());
    if (c1->is(ObjType::Array)) m = std::max(m, c1->arr.size());
    double xn = std::pow(x, n);
    for (size_t i = 0; i < m; i++) {
      double a = arr_at(c0, i, 0.0), b = arr_at(c1, i, 1.0);
      out->push_back(a + xn * (b - a));
    }
    return true;
  }
  if (ft == 3) {  // stitching
    ObjPtr fns = doc->dict_get(fn, "Functions");
    ObjPtr bounds = doc->dict_get(fn, "Bounds");
    ObjPtr enc = doc->dict_get(fn, "Encode");
    if (!fns->is(ObjType::Array) || fns->arr.empty()) return false;
    size_t K = fns->arr.size();
    size_t k = 0;
    while (k + 1 < K && bounds->is(ObjType::Array) && k < bounds->arr.size() &&
           x >= doc->resolve(bounds->arr[k])->num())
      k++;
    double lo = k == 0 ? d0 : arr_at(bounds, k - 1, d0);
    double hi = k == K - 1 ? d1 : arr_at(bounds, k, d1);
    double e0 = arr_at(enc, 2 * k, 0.0), e1 = arr_at(enc, 2 * k + 1, 1.0);
    double xm = hi > lo ? e0 + (x - lo) / (hi - lo) * (e1 - e0) : e0;
    return eval_pdf_function(doc, fns->arr[k], xm, out, depth + 1);
  }
  if (ft == 0) {  // sampled, m input dimensions (multilinear interp)
    ObjPtr size = doc->dict_get(fn, "Size");
    ObjPtr range = doc->dict_get(fn, "Range");
    int bps = (int)doc->dict_get(fn, "BitsPerSample")->num();
    size_t m = xs.size();
    if (!size->is(ObjType::Array) || size->arr.size() < m ||
        !range->is(ObjType::Array) || range->arr.empty())
      return false;
    size_t n = range->arr.size() / 2;
    if (n < 1 || (bps != 1 && bps != 2 && bps != 4 && bps != 8 &&
                  bps != 16))
      return false;
    int szs[4];
    for (size_t k = 0; k < m; k++) {
      szs[k] = (int)doc->resolve(size->arr[k])->num();
      if (szs[k] < 1) return false;
    }
    std::string data = doc->decode_stream(fn);
    ObjPtr enc = doc->dict_get(fn, "Encode");
    ObjPtr dec = doc->dict_get(fn, "Decode");
    int i0s[4];
    double fracs[4];
    for (size_t k = 0; k < m; k++) {
      double lo = arr_at(dom, 2 * k, 0.0), hi = arr_at(dom, 2 * k + 1, 1.0);
      double e0 = arr_at(enc, 2 * k, 0.0);
      double e1 = arr_at(enc, 2 * k + 1, (double)(szs[k] - 1));
      double e = hi > lo ? e0 + (xs[k] - lo) / (hi - lo) * (e1 - e0) : e0;
      e = std::min(std::max(e, 0.0), (double)(szs[k] - 1));
      i0s[k] = (int)e;
      fracs[k] = e - i0s[k];
    }
    double maxv = (double)((1u << (bps == 16 ? 16 : bps)) - 1);
    auto sample = [&](size_t flat, size_t j) -> double {
      size_t bit = (flat * n + j) * bps;
      size_t byte = bit / 8;
      if (byte >= data.size()) return 0.0;
      if (bps == 16) {
        uint32_t v = ((uint8_t)data[byte] << 8);
        if (byte + 1 < data.size()) v |= (uint8_t)data[byte + 1];
        return v;
      }
      if (bps == 8) return (uint8_t)data[byte];
      int shift = 8 - bps - (int)(bit % 8);
      return ((uint8_t)data[byte] >> shift) & ((1 << bps) - 1);
    };
    for (size_t j = 0; j < n; j++) {
      double acc = 0;
      for (unsigned corner = 0; corner < (1u << m); corner++) {
        double wgt = 1;
        size_t flat = 0, stride = 1;
        for (size_t k = 0; k < m; k++) {
          int ik = i0s[k] + ((corner >> k) & 1);
          if (ik > szs[k] - 1) ik = szs[k] - 1;
          wgt *= ((corner >> k) & 1) ? fracs[k] : 1 - fracs[k];
          flat += (size_t)ik * stride;
          stride *= szs[k];
        }
        if (wgt > 0) acc += wgt * sample(flat, j);
      }
      double r0 = arr_at(dec->is(ObjType::Null) ? range : dec, 2 * j, 0.0);
      double r1 = arr_at(dec->is(ObjType::Null) ? range : dec, 2 * j + 1, 1.0);
      out->push_back(r0 + acc / maxv * (r1 - r0));
    }
    return true;
  }
  if (ft == 4 && fn->is(ObjType::Stream)) {  // PostScript calculator
    ObjPtr range = doc->dict_get(fn, "Range");
    if (!range->is(ObjType::Array) || range->arr.size() < 2) return false;
    size_t n = range->arr.size() / 2;
    std::string prog = doc->decode_stream(fn);
    size_t p = 0;
    std::vector<PsTok> toks;
    if (!ps_parse(prog, &p, &toks, 0)) return false;
    // the program text is one outer { ... } block
    const std::vector<PsTok>* body = &toks;
    if (toks.size() == 1 && toks[0].kind == PsTok::Proc) body = &toks[0].proc;
    std::vector<double> st(xs.begin(), xs.end());
    int steps = 0;
    if (!ps_run(*body, &st, &steps)) return false;
    if (st.size() < n) return false;
    for (size_t j = 0; j < n; j++) {
      double v = st[st.size() - n + j];
      double r0 = arr_at(range, 2 * j, 0.0), r1 = arr_at(range, 2 * j + 1, 1.0);
      out->push_back(std::min(std::max(v, r0), r1));
    }
    return true;
  }
  return false;  // unknown function type
}

static void comps_to_rgb(const std::vector<double>& c, float rgb[3]) {
  if (c.size() >= 4) {
    double k = c[3];
    rgb[0] = (float)((1 - c[0]) * (1 - k));
    rgb[1] = (float)((1 - c[1]) * (1 - k));
    rgb[2] = (float)((1 - c[2]) * (1 - k));
  } else if (c.size() == 3) {
    rgb[0] = (float)c[0];
    rgb[1] = (float)c[1];
    rgb[2] = (float)c[2];
  } else if (!c.empty()) {
    rgb[0] = rgb[1] = rgb[2] = (float)c[0];
  } else {
    rgb[0] = rgb[1] = rgb[2] = 0.5f;
  }
  for (int i = 0; i < 3; i++) {
    if (rgb[i] < 0) rgb[i] = 0;
    if (rgb[i] > 1) rgb[i] = 1;
  }
}

// Build a RenderShading (LUT-sampled) from a shading dict; false when the
// ShadingType/Function is unsupported (caller degrades explicitly).
static bool build_shading(Document* doc, const ObjPtr& shin,
                          const Matrix& to_page, RenderShading* rs) {
  ObjPtr sh = doc->resolve(shin);
  if (!sh->is(ObjType::Dict) && !sh->is(ObjType::Stream)) return false;
  int stype = (int)doc->dict_get(sh, "ShadingType")->num();
  if (stype < 1 || stype > 7) return false;
  rs->shading_type = stype;
  if (stype >= 4) {
    // mesh shadings: decode the vertex stream into Gouraud triangles.
    // Types 4 (free-form) and 5 (lattice) decode exactly; Coons/tensor
    // patches (6/7) evaluate the full bicubic tensor surface (type 6
    // interior points derived per spec) tessellated at 8x8 per patch.
    if (!sh->is(ObjType::Stream)) return false;
    int bpc_ = (int)doc->dict_get(sh, "BitsPerCoordinate")->num();
    int bpcomp = (int)doc->dict_get(sh, "BitsPerComponent")->num();
    int bpflag = (int)doc->dict_get(sh, "BitsPerFlag")->num();
    if (bpflag == 0) bpflag = 8;
    ObjPtr decode = doc->dict_get(sh, "Decode");
    if (!decode->is(ObjType::Array) || decode->arr.size() < 6) return false;
    // component count from the Decode array (pairs: x, y, then comps)
    int ncomp = (int)decode->arr.size() / 2 - 2;
    if (ncomp < 1 || ncomp > 4) return false;
    if ((bpc_ != 8 && bpc_ != 16 && bpc_ != 24 && bpc_ != 32) ||
        (bpcomp != 8 && bpcomp != 16))
      return false;
    ObjPtr meshfn = doc->dict_get(sh, "Function");
    bool has_fn = !meshfn->is(ObjType::Null);
    std::string data = doc->decode_stream(sh);
    size_t bitpos = 0, nbits = data.size() * 8;
    auto bits = [&](int n) -> uint64_t {
      uint64_t v = 0;
      for (int i = 0; i < n; i++) {
        if (bitpos >= nbits) return v << (n - i);
        v = (v << 1) |
            (((uint8_t)data[bitpos / 8] >> (7 - bitpos % 8)) & 1);
        bitpos++;
      }
      return v;
    };
    auto dec_at = [&](size_t i) {
      return doc->resolve(decode->arr[i])->num();
    };
    struct MV { float x, y; uint8_t rgb[3]; };
    auto read_vertex = [&](MV* v) -> bool {
      if (bitpos + (size_t)2 * bpc_ + (size_t)ncomp * bpcomp > nbits)
        return false;
      double cmax = (double)((1ull << bpc_) - 1);
      double vmax = (double)((1ull << bpcomp) - 1);
      double x = dec_at(0) + bits(bpc_) / cmax * (dec_at(1) - dec_at(0));
      double y = dec_at(2) + bits(bpc_) / cmax * (dec_at(3) - dec_at(2));
      std::vector<double> comps;
      for (int k = 0; k < ncomp; k++)
        comps.push_back(dec_at(4 + 2 * k) +
                        bits(bpcomp) / vmax *
                            (dec_at(5 + 2 * k) - dec_at(4 + 2 * k)));
      if (has_fn) {
        std::vector<double> outc;
        if (eval_pdf_function_n(doc, meshfn, comps, &outc) && !outc.empty())
          comps = outc;
      }
      float rgb[3] = {0.5f, 0.5f, 0.5f};
      comps_to_rgb(comps, rgb);
      v->x = (float)x;
      v->y = (float)y;
      for (int k = 0; k < 3; k++)
        v->rgb[k] = (uint8_t)(rgb[k] * 255.0f + 0.5f);
      return true;
    };
    auto push_tri = [&](const MV& a, const MV& b, const MV& c) {
      if (rs->tri_xy.size() > 6u * 200000) return;  // runaway guard
      for (const MV* v : {&a, &b, &c}) {
        rs->tri_xy.push_back(v->x);
        rs->tri_xy.push_back(v->y);
        rs->tri_rgb.push_back(v->rgb[0]);
        rs->tri_rgb.push_back(v->rgb[1]);
        rs->tri_rgb.push_back(v->rgb[2]);
      }
    };
    if (stype == 4) {
      MV va, vb, vc;
      int have = 0;
      while (true) {
        if (bitpos + bpflag > nbits) break;
        int flag = (int)bits(bpflag);
        MV v;
        if (!read_vertex(&v)) break;
        if (flag == 0) {
          if (have == 0) { va = v; have = 1; }
          else if (have == 1) { vb = v; have = 2; }
          else { vc = v; have = 3; push_tri(va, vb, vc); have = 3; }
          if (have == 3) have = 0;
        } else if (flag == 1) {  // share vb, vc
          va = vb; vb = vc; vc = v;
          push_tri(va, vb, vc);
        } else {  // flag 2: share va, vc
          vb = vc; vc = v;
          push_tri(va, vb, vc);
        }
      }
    } else if (stype == 5) {
      int per_row = (int)doc->dict_get(sh, "VerticesPerRow")->num();
      if (per_row < 2 || per_row > 65536) return false;
      std::vector<MV> prev, cur;
      while (true) {
        cur.clear();
        bool ok = true;
        for (int i = 0; i < per_row; i++) {
          MV v;
          if (!read_vertex(&v)) { ok = false; break; }
          cur.push_back(v);
        }
        if (!ok) break;
        if (!prev.empty())
          for (int i = 0; i + 1 < per_row; i++) {
            push_tri(prev[i], prev[i + 1], cur[i]);
            push_tri(prev[i + 1], cur[i + 1], cur[i]);
          }
        prev = cur;
      }
    } else {  // 6/7: Coons / tensor patches, evaluated exactly
      // Each patch is a bicubic tensor-product surface S(u,v) =
      // sum_ij p[i][j] B_i(u) B_j(v). Type 6 supplies the 12 boundary
      // control points (interior derived by the spec's Coons formulas);
      // type 7 supplies all 16. Stream order -> tensor grid (row, col):
      //   pts 1..12 walk the boundary p11 p12 p13 p14 p24 p34 p44 p43
      //   p42 p41 p31 p21; type 7 appends interior p22 p23 p33 p32.
      // Corner colors c1..c4 sit at p11, p14, p44, p41. Edge flags 1/2/3
      // reuse the previous patch's p1x / p4x-reversed / px1-reversed edge
      // as the new first row (PDF 32000 tables 85-86).
      static const int kGridRow[16] =
          {0, 0, 0, 0, 1, 2, 3, 3, 3, 3, 2, 1, 1, 1, 2, 2};
      static const int kGridCol[16] =
          {0, 1, 2, 3, 3, 3, 3, 2, 1, 0, 0, 0, 1, 2, 2, 1};
      int npts_new = stype == 6 ? 12 : 16;
      double pg[4][4][2];       // previous patch tensor grid
      float pcol[4][3];         // previous corner colors c1..c4 (0..1)
      bool have_prev = false;
      const int N = 8;          // quads per patch axis (2*N*N triangles)
      while (true) {
        if (bitpos + bpflag > nbits) break;
        int flag = (int)bits(bpflag);
        int npts = flag == 0 ? npts_new : npts_new - 4;
        int ncol = flag == 0 ? 4 : 2;
        std::vector<std::pair<double, double>> pts;
        bool ok = true;
        double cmax = (double)((1ull << bpc_) - 1);
        for (int i = 0; i < npts; i++) {
          if (bitpos + (size_t)2 * bpc_ > nbits) { ok = false; break; }
          double x = dec_at(0) + bits(bpc_) / cmax * (dec_at(1) - dec_at(0));
          double y = dec_at(2) + bits(bpc_) / cmax * (dec_at(3) - dec_at(2));
          pts.push_back({x, y});
        }
        if (!ok) break;
        double vmax = (double)((1ull << bpcomp) - 1);
        float cols[4][3];
        for (int i = 0; i < ncol; i++) {
          std::vector<double> comps;
          for (int k = 0; k < ncomp; k++) {
            if (bitpos + bpcomp > nbits) { ok = false; break; }
            comps.push_back(dec_at(4 + 2 * k) +
                            bits(bpcomp) / vmax *
                                (dec_at(5 + 2 * k) - dec_at(4 + 2 * k)));
          }
          if (!ok) break;
          if (has_fn) {
            std::vector<double> outc;
            if (eval_pdf_function_n(doc, meshfn, comps, &outc) &&
                !outc.empty())
              comps = outc;
          }
          float rgb[3] = {0.5f, 0.5f, 0.5f};
          comps_to_rgb(comps, rgb);
          for (int k = 0; k < 3; k++) cols[i][k] = rgb[k];
        }
        if (!ok) break;
        double g[4][4][2];
        float cc[4][3];
        if (flag == 0) {
          for (int i = 0; i < npts; i++) {
            g[kGridRow[i]][kGridCol[i]][0] = pts[i].first;
            g[kGridRow[i]][kGridCol[i]][1] = pts[i].second;
          }
          memcpy(cc, cols, sizeof(cc));
        } else {
          if (!have_prev) break;
          // shared first row from the previous grid, per flag
          for (int j = 0; j < 4; j++) {
            const double* src =
                flag == 1 ? pg[j][3]                 // p14 p24 p34 p44
                : flag == 2 ? pg[3][3 - j]           // p44 p43 p42 p41
                            : pg[3 - j][0];          // p41 p31 p21 p11
            g[0][j][0] = src[0];
            g[0][j][1] = src[1];
          }
          int ca = flag == 1 ? 1 : flag == 2 ? 2 : 3;  // prev color at p11
          int cb = (ca + 1) & 3;                       // prev color at p14
          for (int k = 0; k < 3; k++) {
            cc[0][k] = pcol[ca][k];
            cc[1][k] = pcol[cb][k];
            cc[2][k] = cols[0][k];
            cc[3][k] = cols[1][k];
          }
          // stream supplies boundary points 5..12 (+ interior for 7)
          for (int i = 0; i < npts; i++) {
            g[kGridRow[4 + i]][kGridCol[4 + i]][0] = pts[i].first;
            g[kGridRow[4 + i]][kGridCol[4 + i]][1] = pts[i].second;
          }
        }
        if (stype == 6) {
          // Coons interior points (PDF 32000 8.7.4.5.8, zero-based)
          for (int c = 0; c < 2; c++) {
            g[1][1][c] = (-4 * g[0][0][c] + 6 * (g[0][1][c] + g[1][0][c]) -
                          2 * (g[0][3][c] + g[3][0][c]) +
                          3 * (g[3][1][c] + g[1][3][c]) - g[3][3][c]) / 9;
            g[1][2][c] = (-4 * g[0][3][c] + 6 * (g[0][2][c] + g[1][3][c]) -
                          2 * (g[0][0][c] + g[3][3][c]) +
                          3 * (g[3][2][c] + g[1][0][c]) - g[3][0][c]) / 9;
            g[2][1][c] = (-4 * g[3][0][c] + 6 * (g[3][1][c] + g[2][0][c]) -
                          2 * (g[3][3][c] + g[0][0][c]) +
                          3 * (g[0][1][c] + g[2][3][c]) - g[0][3][c]) / 9;
            g[2][2][c] = (-4 * g[3][3][c] + 6 * (g[3][2][c] + g[2][3][c]) -
                          2 * (g[3][0][c] + g[0][3][c]) +
                          3 * (g[0][2][c] + g[2][0][c]) - g[0][0][c]) / 9;
          }
        }
        // tessellate: sample S(u,v) and the bilinear corner-color sheet
        // on an (N+1)x(N+1) grid, emit 2 triangles per cell
        MV grid[N + 1][N + 1];
        for (int iu = 0; iu <= N; iu++) {
          double u = (double)iu / N;
          double bu[4] = {(1 - u) * (1 - u) * (1 - u),
                          3 * u * (1 - u) * (1 - u),
                          3 * u * u * (1 - u), u * u * u};
          for (int iv = 0; iv <= N; iv++) {
            double v = (double)iv / N;
            double bv[4] = {(1 - v) * (1 - v) * (1 - v),
                            3 * v * (1 - v) * (1 - v),
                            3 * v * v * (1 - v), v * v * v};
            double x = 0, y = 0;
            for (int i = 0; i < 4; i++)
              for (int j = 0; j < 4; j++) {
                double w = bu[i] * bv[j];
                x += w * g[i][j][0];
                y += w * g[i][j][1];
              }
            MV* m = &grid[iu][iv];
            m->x = (float)x;
            m->y = (float)y;
            for (int k = 0; k < 3; k++) {
              double col = (1 - u) * (1 - v) * cc[0][k] +
                           (1 - u) * v * cc[1][k] + u * v * cc[2][k] +
                           u * (1 - v) * cc[3][k];
              m->rgb[k] = (uint8_t)(col * 255.0 + 0.5);
            }
          }
        }
        for (int iu = 0; iu < N; iu++)
          for (int iv = 0; iv < N; iv++) {
            push_tri(grid[iu][iv], grid[iu][iv + 1], grid[iu + 1][iv]);
            push_tri(grid[iu][iv + 1], grid[iu + 1][iv + 1],
                     grid[iu + 1][iv]);
          }
        memcpy(pg, g, sizeof(pg));
        memcpy(pcol, cc, sizeof(pcol));
        have_prev = true;
      }
    }
    if (rs->tri_xy.empty()) return false;
    rs->shade_to_page = to_page;
    return true;
  }
  if (stype == 1) {
    // function-based: sample f(x, y) over the Domain rectangle into a
    // 2D LUT; the optional /Matrix maps domain space into shading space
    double dd[4] = {0, 1, 0, 1};
    ObjPtr dm1 = doc->dict_get(sh, "Domain");
    if (dm1->is(ObjType::Array) && dm1->arr.size() >= 4)
      for (int i = 0; i < 4; i++) dd[i] = doc->resolve(dm1->arr[i])->num();
    ObjPtr fn1 = doc->dict_get(sh, "Function");
    if (fn1->is(ObjType::Null)) return false;
    Matrix fmtx;
    ObjPtr fm = doc->dict_get(sh, "Matrix");
    if (fm->is(ObjType::Array) && fm->arr.size() == 6)
      fmtx = Matrix{doc->resolve(fm->arr[0])->num(),
                    doc->resolve(fm->arr[1])->num(),
                    doc->resolve(fm->arr[2])->num(),
                    doc->resolve(fm->arr[3])->num(),
                    doc->resolve(fm->arr[4])->num(),
                    doc->resolve(fm->arr[5])->num()};
    const int L = RenderShading::kLut2d;
    rs->lut2d.resize((size_t)L * L * 3);
    for (int yi = 0; yi < L; yi++) {
      double y = dd[2] + (dd[3] - dd[2]) * yi / (L - 1.0);
      for (int xi = 0; xi < L; xi++) {
        double x = dd[0] + (dd[1] - dd[0]) * xi / (L - 1.0);
        std::vector<double> c;
        float rgb[3] = {0.5f, 0.5f, 0.5f};
        if (eval_pdf_function_n(doc, fn1, {x, y}, &c)) comps_to_rgb(c, rgb);
        uint8_t* px = rs->lut2d.data() + ((size_t)yi * L + xi) * 3;
        for (int k = 0; k < 3; k++)
          px[k] = (uint8_t)(rgb[k] * 255.0f + 0.5f);
      }
    }
    for (int i = 0; i < 4; i++) rs->dom2d[i] = (float)dd[i];
    rs->shade_to_page = fmtx.mul(to_page);
    return true;
  }
  ObjPtr co = doc->dict_get(sh, "Coords");
  int need = stype == 2 ? 4 : 6;
  if (!co->is(ObjType::Array) || (int)co->arr.size() < need) return false;
  for (int i = 0; i < need; i++)
    rs->coords[i] = (float)doc->resolve(co->arr[i])->num();
  double t0 = 0, t1 = 1;
  ObjPtr dm = doc->dict_get(sh, "Domain");
  if (dm->is(ObjType::Array) && dm->arr.size() >= 2) {
    t0 = doc->resolve(dm->arr[0])->num();
    t1 = doc->resolve(dm->arr[1])->num();
  }
  ObjPtr ex = doc->dict_get(sh, "Extend");
  if (ex->is(ObjType::Array) && ex->arr.size() >= 2) {
    rs->extend0 = doc->resolve(ex->arr[0])->b;
    rs->extend1 = doc->resolve(ex->arr[1])->b;
  }
  ObjPtr fn = doc->dict_get(sh, "Function");
  if (fn->is(ObjType::Null)) return false;
  for (int i = 0; i < 256; i++) {
    double t = t0 + (t1 - t0) * i / 255.0;
    std::vector<double> c;
    float rgb[3] = {0.5f, 0.5f, 0.5f};
    if (eval_pdf_function(doc, fn, t, &c)) comps_to_rgb(c, rgb);
    rs->lut[i][0] = (uint8_t)(rgb[0] * 255.0f + 0.5f);
    rs->lut[i][1] = (uint8_t)(rgb[1] * 255.0f + 0.5f);
    rs->lut[i][2] = (uint8_t)(rgb[2] * 255.0f + 0.5f);
  }
  rs->shade_to_page = to_page;
  return true;
}

// colorspace family for sc/scn operand interpretation (PDF 8.6)
enum class CsKind { Gray, Rgb, Cmyk, Sep, Pattern, Other };

struct GState {
  Matrix ctm;
  float stroke_rgb[3] = {0, 0, 0};
  float fill_rgb[3] = {0, 0, 0};
  // dash pattern (user-space units) + phase; empty = solid
  std::vector<double> dash;
  double dash_phase = 0;
  // ExtGState constant alpha (/ca fill, /CA stroke)
  float fill_alpha = 1.0f, stroke_alpha = 1.0f;
  // ExtGState /BM blend mode + /SMask soft-mask group (spdf.h encoding)
  int blend_mode = 0;
  std::shared_ptr<SoftMaskSpec> smask;
  // PatternType-2 (shading) fill state: set by `/Pattern cs ... /P scn`,
  // consumed by paint_path. Null when the fill color is a plain color.
  ObjPtr fill_pattern_shading;
  Matrix fill_pattern_mtx;
  // PatternType-1 (tiling) fill state: pre-interpreted cell display
  // list + tiling geometry (pattern space)
  std::shared_ptr<DisplayList> fill_tile_dl;
  float tile_x0 = 0, tile_y0 = 0, tile_w = 0, tile_h = 0;
  float tile_xstep = 0, tile_ystep = 0;
  bool fill_cs_pattern = false;  // current fill colorspace is /Pattern
  CsKind fill_cs = CsKind::Rgb;
  CsKind stroke_cs = CsKind::Rgb;
  // resolved colorspace objects (Separation tint transforms live here)
  ObjPtr fill_cs_obj, stroke_cs_obj;
  double line_width = 1.0;
  Rect clip{-1e30, -1e30, 1e30, 1e30};
  // text state
  std::shared_ptr<PdfFont> font;
  double font_size = 0;
  double char_spacing = 0, word_spacing = 0, horiz_scale = 1.0, leading = 0;
  double rise = 0;
  int render_mode = 0;
};

// Classify a colorspace object so sc/scn operands are interpreted with
// the right semantics (PDF 8.6). Separation/DeviceN matter most in
// practice: print-grade books set spot colors where tint 1.0 means FULL
// colorant — interpreting the tint as DeviceGray painted them white.
static CsKind classify_cs(Document* doc, const ObjPtr& resources, ObjPtr cs,
                          int depth = 0) {
  if (depth > 4) return CsKind::Other;
  cs = doc->resolve(cs);
  if (cs->is(ObjType::Name)) {
    const std::string& n = cs->s;
    if (n == "DeviceGray" || n == "CalGray" || n == "G") return CsKind::Gray;
    if (n == "DeviceRGB" || n == "CalRGB" || n == "RGB") return CsKind::Rgb;
    if (n == "DeviceCMYK" || n == "CMYK") return CsKind::Cmyk;
    if (n == "Pattern") return CsKind::Pattern;
    ObjPtr csd = doc->dict_get(resources, "ColorSpace");
    if (csd->is(ObjType::Dict)) {
      ObjPtr ref = doc->dict_get(csd, n);
      if (!ref->is(ObjType::Null))
        return classify_cs(doc, make_null(), ref, depth + 1);
    }
    return CsKind::Other;
  }
  if (cs->is(ObjType::Array) && !cs->arr.empty()) {
    ObjPtr f = doc->resolve(cs->arr[0]);
    if (!f->is(ObjType::Name)) return CsKind::Other;
    const std::string& n = f->s;
    if (n == "ICCBased" && cs->arr.size() >= 2) {
      int nc = (int)doc->dict_get(doc->resolve(cs->arr[1]), "N")->num();
      return nc == 1 ? CsKind::Gray : nc == 4 ? CsKind::Cmyk : CsKind::Rgb;
    }
    if (n == "Separation" || n == "DeviceN") return CsKind::Sep;
    if (n == "Pattern") return CsKind::Pattern;
    if (n == "CalRGB") return CsKind::Rgb;
    if (n == "CalGray") return CsKind::Gray;
  }
  return CsKind::Other;  // Indexed/Lab/unknown: arity heuristic below
}

// Exact Separation (and 1-component DeviceN) color: run the colorspace's
// tint transform into the alternate space. Without this a spot color
// approximates as neutral ink — a PANTONE red painted BLACK.
static bool sep_exact_rgb(Document* doc, const ObjPtr& cs,
                          const std::vector<double>& tints, float rgb[3]) {
  if (!cs || !cs->is(ObjType::Array) || cs->arr.size() < 4) return false;
  ObjPtr names = doc->resolve(cs->arr[1]);
  size_t ncolorants =
      names->is(ObjType::Array) ? names->arr.size() : 1;
  if (tints.size() != ncolorants || ncolorants > 4) return false;
  std::vector<double> comps;
  if (!eval_pdf_function_n(doc, cs->arr[3], tints, &comps) || comps.empty())
    return false;
  comps_to_rgb(comps, rgb);
  return true;
}

// Convert sc/scn numeric operands to RGB per the active colorspace.
// num(k) reads the k-th operand from the stack top (num(1) = last).
template <typename NumFn>
static void operands_to_rgb(CsKind k, size_t nops, const NumFn& num,
                            float* rgb) {
  if (k == CsKind::Other) {  // arity heuristic for unclassified spaces
    k = nops >= 4 ? CsKind::Cmyk : nops >= 3 ? CsKind::Rgb : CsKind::Gray;
  }
  switch (k) {
    case CsKind::Gray:
      if (nops >= 1) rgb[0] = rgb[1] = rgb[2] = (float)num(1);
      break;
    case CsKind::Rgb:
      if (nops >= 3) {
        rgb[0] = (float)num(3);
        rgb[1] = (float)num(2);
        rgb[2] = (float)num(1);
      }
      break;
    case CsKind::Cmyk:
      if (nops >= 4) {
        double kk = num(1);
        rgb[0] = (float)((1 - num(4)) * (1 - kk));
        rgb[1] = (float)((1 - num(3)) * (1 - kk));
        rgb[2] = (float)((1 - num(2)) * (1 - kk));
      }
      break;
    case CsKind::Sep: {
      // tint 1.0 = full colorant (dark); approximate the colorant as
      // neutral ink at the max tint across DeviceN components
      double t = 0;
      for (size_t i = 1; i <= nops && i <= 8; i++) t = std::max(t, num((int)i));
      rgb[0] = rgb[1] = rgb[2] = (float)(1.0 - t);
      break;
    }
    default:
      break;
  }
}

struct Interp {
  Document* doc;
  PageContent* out;
  DisplayList* dl;
  GState gs;
  // optional content (layers): OCGs turned OFF by the catalog's default
  // configuration; content inside /OC marked sections (or xobjects with
  // an /OC entry) referencing them does not RENDER. Text metadata is
  // still extracted, matching fitz's get_text behavior.
  std::unordered_set<const Object*> hidden_ocgs;
  std::vector<bool> mc_stack;  // open marked-content levels: suppressing?
  int mc_suppressed = 0;
  bool suppressed() const { return mc_suppressed > 0; }
  bool ocg_hidden(const ObjPtr& oc) {
    ObjPtr o = doc->resolve(oc);
    if (!o->is(ObjType::Dict)) return false;
    ObjPtr type = doc->dict_get(o, "Type");
    if (type->is(ObjType::Name) && type->s == "OCMD") {
      ObjPtr gsd = doc->dict_get(o, "OCGs");
      if (gsd->is(ObjType::Dict))
        return hidden_ocgs.count(gsd.get()) > 0;
      if (gsd->is(ObjType::Array) && !gsd->arr.empty()) {
        // default AnyOn visibility: hidden only if ALL groups are off
        for (auto& g : gsd->arr)
          if (!hidden_ocgs.count(doc->resolve(g).get())) return false;
        return true;
      }
      return false;
    }
    return hidden_ocgs.count(o.get()) > 0;
  }
  Matrix base_ctm;  // page default space (pattern matrices map into this)
  std::vector<GState> gstack;
  Matrix tm, tlm;  // text matrix, text line matrix
  bool in_text = false;

  // current path
  std::vector<std::vector<std::pair<float, float>>> subpaths;
  double cur_x = 0, cur_y = 0;
  bool pending_clip = false, pending_clip_eo = false;

  // span accumulation
  TextSpan cur_span;
  double span_end_x = 0, span_end_y = 0;
  bool span_open = false;
  RenderGlyphRun cur_run;

  std::unordered_map<std::string, std::shared_ptr<PdfFont>> font_cache;
  int depth = 0;

  void flush_span() {
    if (span_open && !cur_span.text.empty() && cur_span.bbox.valid())
      out->spans.push_back(cur_span);
    if (!cur_run.glyph_insts.empty()) {
      dl->order_kind.push_back(1);
      dl->order_index.push_back((int)dl->glyphs.size());
      dl->glyphs.push_back(std::move(cur_run));
      cur_run = RenderGlyphRun();
    }
    span_open = false;
    cur_span = TextSpan();
  }

  void run_stream(const std::string& content, const ObjPtr& resources);
  void op_show_text(const std::string& s, const ObjPtr& resources);
  void paint_path(bool fill, bool stroke, bool even_odd);
  void do_xobject(const std::string& name, const ObjPtr& resources);
  bool build_tile_pattern(const ObjPtr& pat, const Matrix& pm);
  std::shared_ptr<SoftMaskSpec> build_softmask(const ObjPtr& sm);

  // per-page tile-cell cache: a pattern reused across many fills
  // (hatched bar charts) interprets its cell stream once
  struct TileCell {
    std::shared_ptr<DisplayList> dl;
    float x0, y0, w, h, xstep, ystep;
  };
  std::map<const Object*, TileCell> tile_cache;
};

static void utf8_append(std::string* s, uint32_t cp) {
  if (cp < 0x80) {
    *s += (char)cp;
  } else if (cp < 0x800) {
    *s += (char)(0xC0 | (cp >> 6));
    *s += (char)(0x80 | (cp & 0x3F));
  } else if (cp < 0x10000) {
    *s += (char)(0xE0 | (cp >> 12));
    *s += (char)(0x80 | ((cp >> 6) & 0x3F));
    *s += (char)(0x80 | (cp & 0x3F));
  } else {
    *s += (char)(0xF0 | (cp >> 18));
    *s += (char)(0x80 | ((cp >> 12) & 0x3F));
    *s += (char)(0x80 | ((cp >> 6) & 0x3F));
    *s += (char)(0x80 | (cp & 0x3F));
  }
}

void Interp::op_show_text(const std::string& s, const ObjPtr& resources) {
  (void)resources;
  if (!gs.font) return;
  PdfFont* f = gs.font.get();
  size_t i = 0;
  while (i < s.size()) {
    uint32_t code;
    if (f->two_byte) {
      if (i + 1 >= s.size()) break;
      code = ((uint8_t)s[i] << 8) | (uint8_t)s[i + 1];
      i += 2;
    } else {
      code = (uint8_t)s[i++];
    }
    double w0 = f->width_for_code(code) / 1000.0;
    // text rendering matrix
    Matrix param{gs.font_size * gs.horiz_scale, 0, 0, gs.font_size,
                 0, gs.rise};
    Matrix trm = param.mul(tm).mul(gs.ctm);
    uint32_t uni = f->unicode_for_code(code);
    // glyph box in text space: x [0,w0], y [-0.25, 0.8] em approx
    double gx0, gy0, gx1, gy1;
    trm.apply(0, -0.22, &gx0, &gy0);
    trm.apply(w0, 0.78, &gx1, &gy1);
    Rect gb;
    gb.grow(gx0, gy0);
    gb.grow(gx1, gy1);
    double asc2x, asc2y;
    trm.apply(0, 0.78, &asc2x, &asc2y);
    gb.grow(asc2x, asc2y);
    trm.apply(w0, -0.22, &asc2x, &asc2y);
    gb.grow(asc2x, asc2y);

    bool is_space = (uni == ' ' || (uni == 0 && code == 32));
    // span management: break on font change/size change/jump
    double ox, oy;
    trm.apply(0, 0, &ox, &oy);
    double dev_size = gs.font_size * std::sqrt(std::fabs(
        gs.ctm.a * gs.ctm.d - gs.ctm.b * gs.ctm.c));
    if (span_open) {
      bool same_line = std::fabs(oy - span_end_y) < dev_size * 0.4;
      bool contiguous = std::fabs(ox - span_end_x) < dev_size * 0.75;
      if (!same_line || !contiguous || cur_span.font != f->base_font ||
          std::fabs(cur_span.size - dev_size) > 0.1) {
        flush_span();
      }
    }
    if (!span_open) {
      span_open = true;
      cur_span.font = f->base_font;
      cur_span.size = dev_size;
      cur_run.rgb[0] = gs.fill_rgb[0];
      cur_run.rgb[1] = gs.fill_rgb[1];
      cur_run.rgb[2] = gs.fill_rgb[2];
      cur_run.clip = gs.clip;
      cur_run.blend_mode = gs.blend_mode;
      cur_run.smask = gs.smask;
    }
    if (!is_space || !cur_span.text.empty()) {
      if (uni) utf8_append(&cur_span.text, uni);
      else if (!f->is_cid) cur_span.text += (char)(code & 0x7F ? code : '?');
      else cur_span.text += '?';
      cur_span.bbox.grow(gb.x0, gb.y0);
      cur_span.bbox.grow(gb.x1, gb.y1);
    }
    // Type3: replay the glyph's CharProc content stream through this
    // interpreter with CTM = FontMatrix x TRM (full fidelity: paths,
    // images, nested state). Span text above already used Differences.
    if (gs.render_mode != 3 && !suppressed() && f->is_type3 && !is_space &&
        depth < 12) {
      auto pit = f->t3_procs.find(code);
      if (pit != f->t3_procs.end()) {
        GState saved_gs = gs;
        Matrix saved_tm = tm, saved_tlm = tlm;
        bool saved_in_text = in_text;
        auto saved_paths = std::move(subpaths);
        subpaths.clear();
        double saved_cx = cur_x, saved_cy = cur_y;
        bool saved_pc = pending_clip, saved_pce = pending_clip_eo;
        size_t saved_stack = gstack.size();
        gs.ctm = f->t3_matrix.mul(trm);
        gs.font = nullptr;  // glyph streams set their own text state
        in_text = false;
        ObjPtr proc = doc->resolve(pit->second);
        ObjPtr res = f->t3_resources && f->t3_resources->is(ObjType::Dict)
                         ? f->t3_resources
                         : resources;
        depth++;
        run_stream(doc->decode_stream(proc), res);
        depth--;
        if (gstack.size() > saved_stack) gstack.resize(saved_stack);
        gs = saved_gs;
        tm = saved_tm;
        tlm = saved_tlm;
        in_text = saved_in_text;
        subpaths = std::move(saved_paths);
        cur_x = saved_cx;
        cur_y = saved_cy;
        pending_clip = saved_pc;
        pending_clip_eo = saved_pce;
      }
    }
    // glyph outlines for rasterization (skip invisible mode 3)
    if (gs.render_mode != 3 && !suppressed() && f->ttf && !is_space) {
      uint16_t gid = f->gid_for_code(code);
      if (gid) {
        const Glyph* g = f->ttf->glyph(gid);
        if (!g->contours.empty()) {
          float upem = f->ttf->units_per_em();
          RenderGlyphRun::GlyphInst inst;
          inst.glyph = g;
          inst.a = (float)(trm.a / upem);
          inst.b = (float)(trm.b / upem);
          inst.c = (float)(trm.c / upem);
          inst.d = (float)(trm.d / upem);
          inst.e = (float)trm.e;
          inst.f = (float)trm.f;
          cur_run.glyph_insts.push_back(inst);
        }
      }
    }
    // advance
    double tx = (w0 * gs.font_size + gs.char_spacing +
                 (is_space ? gs.word_spacing : 0)) *
                gs.horiz_scale;
    Matrix tr{1, 0, 0, 1, tx, 0};
    tm = tr.mul(tm);
    trm = param.mul(tm).mul(gs.ctm);
    trm.apply(0, 0, &span_end_x, &span_end_y);
  }
}

// Split flattened subpaths (page space) into dashed "on" polylines.
// Pattern/phase are pre-scaled to page units by the caller. Dashed
// gridlines are everywhere in charts; rendering them solid skewed the
// morphological line/grid detection signals vs the reference renderer.
static std::vector<std::vector<std::pair<float, float>>> dash_polylines(
    const std::vector<std::vector<std::pair<float, float>>>& sps,
    const std::vector<double>& pattern, double phase) {
  double total = 0;
  for (double v : pattern) total += std::max(v, 0.0);
  // degenerate or abusive patterns (tiny dashes over long paths explode
  // the segment count): render solid
  if (total < 0.05) return sps;
  std::vector<std::vector<std::pair<float, float>>> out;
  for (auto& sp : sps) {
    if (sp.size() < 2) continue;
    // advance the pattern cursor by the phase (cycle = 2*total for
    // odd-length patterns, whose on/off parity flips each pass)
    double cycle = (pattern.size() % 2) ? 2 * total : total;
    double left = std::fmod(std::max(phase, 0.0), cycle);
    size_t pi = 0;
    bool on = true;
    double rem = std::max(pattern[0], 0.0);
    while (left > 1e-9) {
      if (left >= rem) {
        left -= rem;
        pi = (pi + 1) % pattern.size();
        on = !on;
        rem = std::max(pattern[pi], 0.0);
      } else {
        rem -= left;
        left = 0;
      }
    }
    std::vector<std::pair<float, float>> cur;
    for (size_t i = 0; i + 1 < sp.size(); i++) {
      double x0 = sp[i].first, y0 = sp[i].second;
      double dx = sp[i + 1].first - x0, dy = sp[i + 1].second - y0;
      double len = std::sqrt(dx * dx + dy * dy);
      if (len < 1e-12) continue;
      double t = 0;
      while (t < len) {
        if (out.size() > 50000) return sps;  // runaway guard: solid
        double step = std::min(rem, len - t);
        double t2 = t + step;
        if (on) {
          if (cur.empty())
            cur.push_back({(float)(x0 + dx * (t / len)),
                           (float)(y0 + dy * (t / len))});
          cur.push_back({(float)(x0 + dx * (t2 / len)),
                         (float)(y0 + dy * (t2 / len))});
        }
        rem -= step;
        t = t2;
        if (rem <= 1e-9) {
          if (on && cur.size() >= 2) out.push_back(std::move(cur));
          cur.clear();
          pi = (pi + 1) % pattern.size();
          on = !on;
          rem = std::max(pattern[pi], 0.0);
        }
      }
    }
    if (on && cur.size() >= 2) out.push_back(std::move(cur));
  }
  return out;
}

// Interpret a PatternType-1 cell content stream into its own display
// list (cell-local y-down space) and arm the tiling fill state. Returns
// false on malformed geometry so the caller degrades to mid-gray.
bool Interp::build_tile_pattern(const ObjPtr& pat, const Matrix& pm) {
  if (depth >= 8) return false;
  // PaintType-2 (uncolored) cells bake the caller's fill color into the
  // interpreted display list, so they must not be shared via the cache
  bool uncolored = (int)doc->dict_get(pat, "PaintType")->num() == 2;
  TileCell cell;
  auto cached = uncolored ? tile_cache.end() : tile_cache.find(pat.get());
  if (cached != tile_cache.end()) {
    cell = cached->second;
  } else {
    ObjPtr bbox = doc->dict_get(pat, "BBox");
    if (!bbox->is(ObjType::Array) || bbox->arr.size() != 4) return false;
    double xa = doc->resolve(bbox->arr[0])->num();
    double ya = doc->resolve(bbox->arr[1])->num();
    double xb = doc->resolve(bbox->arr[2])->num();
    double yb = doc->resolve(bbox->arr[3])->num();
    double bx0 = std::min(xa, xb), by0 = std::min(ya, yb);
    double bw = std::fabs(xb - xa), bh = std::fabs(yb - ya);
    if (!(bw > 1e-6) || !(bh > 1e-6) || !std::isfinite(bw + bh))
      return false;
    double xstep = doc->dict_get(pat, "XStep")->num();
    double ystep = doc->dict_get(pat, "YStep")->num();
    xstep = std::fabs(xstep) > 1e-6 ? std::fabs(xstep) : bw;
    ystep = std::fabs(ystep) > 1e-6 ? std::fabs(ystep) : bh;
    // interpret the cell into a fresh display list, reusing this
    // interpreter with swapped targets (same pattern as Type3 replay)
    auto tdl = std::make_shared<DisplayList>();
    tdl->page_w = bw;
    tdl->page_h = bh;
    PageContent scratch;
    GState saved_gs = gs;
    DisplayList* saved_dl = dl;
    PageContent* saved_out = out;
    Matrix saved_tm = tm, saved_tlm = tlm;
    bool saved_in_text = in_text;
    auto saved_paths = std::move(subpaths);
    subpaths.clear();
    double saved_cx = cur_x, saved_cy = cur_y;
    size_t saved_stack = gstack.size();
    bool saved_pc = pending_clip, saved_pce = pending_clip_eo;
    gs = GState();
    // cell-local device space: y-down, origin at the bbox top-left.
    // PaintType 2 (uncolored) cells paint in the CURRENT fill color —
    // GState() starts black; carry the caller's color over instead.
    if (uncolored)
      for (int k = 0; k < 3; k++) {
        gs.fill_rgb[k] = saved_gs.fill_rgb[k];
        gs.stroke_rgb[k] = saved_gs.stroke_rgb[k];
      }
    gs.ctm = Matrix{1, 0, 0, -1, -bx0, by0 + bh};
    gs.clip = Rect{0, 0, bw, bh};
    dl = tdl.get();
    out = &scratch;
    in_text = false;
    ObjPtr res = doc->dict_get(pat, "Resources");
    depth++;
    run_stream(doc->decode_stream(pat), res);
    depth--;
    if (gstack.size() > saved_stack) gstack.resize(saved_stack);
    gs = saved_gs;
    dl = saved_dl;
    out = saved_out;
    tm = saved_tm;
    tlm = saved_tlm;
    in_text = saved_in_text;
    subpaths = std::move(saved_paths);
    cur_x = saved_cx;
    cur_y = saved_cy;
    pending_clip = saved_pc;
    pending_clip_eo = saved_pce;
    cell = TileCell{tdl, (float)bx0, (float)by0, (float)bw, (float)bh,
                    (float)xstep, (float)ystep};
    if (!uncolored) tile_cache[pat.get()] = cell;
  }
  if (!cell.dl) return false;
  gs.fill_tile_dl = cell.dl;
  gs.tile_x0 = cell.x0;
  gs.tile_y0 = cell.y0;
  gs.tile_w = cell.w;
  gs.tile_h = cell.h;
  gs.tile_xstep = cell.xstep;
  gs.tile_ystep = cell.ystep;
  gs.fill_pattern_mtx = pm.mul(base_ctm);
  return true;
}

// ExtGState /SMask: interpret the mask's /G transparency-group form into
// its own page-space display list (rendered with the CTM in effect at the
// gs operator, per PDF 11.6.5.2). The raster turns it into a per-pixel
// coverage multiplier. Returns null for malformed masks (treated as
// /None — opaque), which also covers the /S /Alpha-without-group case.
std::shared_ptr<SoftMaskSpec> Interp::build_softmask(const ObjPtr& sm) {
  if (!sm->is(ObjType::Dict) || depth >= 8) return nullptr;
  ObjPtr g = doc->resolve(doc->dict_get(sm, "G"));
  if (!g->is(ObjType::Stream)) return nullptr;
  auto spec = std::make_shared<SoftMaskSpec>();
  ObjPtr s = doc->dict_get(sm, "S");
  spec->luminosity = !(s->is(ObjType::Name) && s->s == "Alpha");
  ObjPtr bc = doc->dict_get(sm, "BC");
  if (bc->is(ObjType::Array) && !bc->arr.empty()) {
    // backdrop in the group's colorspace; gray/RGB components cover the
    // real-world cases (1 or 3 numbers)
    if (bc->arr.size() >= 3) {
      for (int k = 0; k < 3; k++)
        spec->backdrop[k] = (float)doc->resolve(bc->arr[k])->num();
    } else {
      float v = (float)doc->resolve(bc->arr[0])->num();
      spec->backdrop[0] = spec->backdrop[1] = spec->backdrop[2] = v;
    }
  }
  Matrix group_ctm = gs.ctm;
  ObjPtr mtx = doc->dict_get(g, "Matrix");
  if (mtx->is(ObjType::Array) && mtx->arr.size() == 6) {
    Matrix m{doc->resolve(mtx->arr[0])->num(),
             doc->resolve(mtx->arr[1])->num(),
             doc->resolve(mtx->arr[2])->num(),
             doc->resolve(mtx->arr[3])->num(),
             doc->resolve(mtx->arr[4])->num(),
             doc->resolve(mtx->arr[5])->num()};
    group_ctm = m.mul(group_ctm);
  }
  // /BBox (required for forms) clips the group; map to a page-space rect
  Rect bclip{-1e30, -1e30, 1e30, 1e30};
  ObjPtr bbox = doc->dict_get(g, "BBox");
  if (bbox->is(ObjType::Array) && bbox->arr.size() == 4) {
    double xa = doc->resolve(bbox->arr[0])->num();
    double ya = doc->resolve(bbox->arr[1])->num();
    double xb = doc->resolve(bbox->arr[2])->num();
    double yb = doc->resolve(bbox->arr[3])->num();
    Rect r;
    for (int k = 0; k < 4; k++) {
      double px, py;
      group_ctm.apply(k & 1 ? xb : xa, k & 2 ? yb : ya, &px, &py);
      r.grow((float)px, (float)py);
    }
    bclip = r;
  }
  auto mdl = std::make_shared<DisplayList>();
  mdl->page_w = dl->page_w;
  mdl->page_h = dl->page_h;
  PageContent scratch;
  GState saved_gs = gs;
  DisplayList* saved_dl = dl;
  PageContent* saved_out = out;
  Matrix saved_tm = tm, saved_tlm = tlm;
  bool saved_in_text = in_text;
  auto saved_paths = std::move(subpaths);
  subpaths.clear();
  double saved_cx = cur_x, saved_cy = cur_y;
  size_t saved_stack = gstack.size();
  bool saved_pc = pending_clip, saved_pce = pending_clip_eo;
  flush_span();
  gs = GState();
  gs.ctm = group_ctm;
  gs.clip = bclip;
  dl = mdl.get();
  out = &scratch;
  in_text = false;
  ObjPtr res = doc->dict_get(g, "Resources");
  depth++;
  run_stream(doc->decode_stream(g), res);
  depth--;
  flush_span();
  if (gstack.size() > saved_stack) gstack.resize(saved_stack);
  gs = saved_gs;
  dl = saved_dl;
  out = saved_out;
  tm = saved_tm;
  tlm = saved_tlm;
  in_text = saved_in_text;
  subpaths = std::move(saved_paths);
  cur_x = saved_cx;
  cur_y = saved_cy;
  pending_clip = saved_pc;
  pending_clip_eo = saved_pce;
  spec->dl = mdl;
  return spec;
}

void Interp::paint_path(bool fill, bool stroke, bool even_odd) {
  if (suppressed()) {  // hidden optional content: consume, paint nothing
    fill = stroke = false;
  }
  if (subpaths.empty() || (!fill && !stroke && !pending_clip)) {
    if (pending_clip) {
      // clip with empty path -> leave as-is
      pending_clip = false;
    }
    subpaths.clear();
    return;
  }
  // device-space bbox
  Rect bb;
  size_t pts = 0;
  for (auto& sp : subpaths)
    for (auto& p : sp) {
      bb.grow(p.first, p.second);
      pts++;
    }
  if (fill || stroke) {
    DrawItem item;
    item.bbox = bb;
    item.kind = fill && stroke ? 2 : (fill ? 1 : 0);
    item.item_count = (int)subpaths.size();
    // rect check: single 5-point closed subpath, axis aligned
    if (subpaths.size() == 1 && (subpaths[0].size() == 5 || subpaths[0].size() == 4)) {
      item.is_rect = true;
      for (auto& p : subpaths[0])
        if (std::fabs(p.first - bb.x0) > 0.01 && std::fabs(p.first - bb.x1) > 0.01)
          item.is_rect = false;
    }
    // clip to current clip region for extraction sanity
    if (bb.x1 >= gs.clip.x0 && bb.x0 <= gs.clip.x1 && bb.y1 >= gs.clip.y0 &&
        bb.y0 <= gs.clip.y1)
      out->drawings.push_back(item);

    // shading-pattern fill: the filled path becomes the paint boundary
    if (fill && gs.fill_pattern_shading) {
      RenderShading rs;
      if (build_shading(doc, gs.fill_pattern_shading, gs.fill_pattern_mtx,
                        &rs)) {
        rs.clip = gs.clip;
        rs.clip_path = subpaths;
        rs.even_odd = even_odd;
        rs.blend_mode = gs.blend_mode;
        rs.smask = gs.smask;
        rs.const_alpha = gs.fill_alpha;
        dl->order_kind.push_back(3);
        dl->order_index.push_back((int)dl->shadings.size());
        dl->shadings.push_back(std::move(rs));
        fill = false;  // plain fill replaced by the shading paint
      } else {
        // unsupported shading type: mid-gray degrade (keep ink)
        gs.fill_rgb[0] = gs.fill_rgb[1] = gs.fill_rgb[2] = 0.5f;
      }
    }

    RenderPath rp;
    rp.subpaths = subpaths;
    rp.fill = fill;
    rp.stroke = stroke;
    rp.even_odd = even_odd;
    if (fill && gs.fill_tile_dl) {
      rp.tile_dl = gs.fill_tile_dl;
      rp.tile_x0 = gs.tile_x0;
      rp.tile_y0 = gs.tile_y0;
      rp.tile_w = gs.tile_w;
      rp.tile_h = gs.tile_h;
      rp.tile_xstep = gs.tile_xstep;
      rp.tile_ystep = gs.tile_ystep;
      rp.tile_to_page = gs.fill_pattern_mtx;
    }
    rp.rgb_fill[0] = gs.fill_rgb[0];
    rp.rgb_fill[1] = gs.fill_rgb[1];
    rp.rgb_fill[2] = gs.fill_rgb[2];
    rp.rgb_stroke[0] = gs.stroke_rgb[0];
    rp.rgb_stroke[1] = gs.stroke_rgb[1];
    rp.rgb_stroke[2] = gs.stroke_rgb[2];
    double sc = std::sqrt(std::fabs(gs.ctm.a * gs.ctm.d - gs.ctm.b * gs.ctm.c));
    rp.line_width = (float)(gs.line_width * sc);
    rp.clip = gs.clip;
    rp.fill_alpha = gs.fill_alpha;
    rp.stroke_alpha = gs.stroke_alpha;
    rp.blend_mode = gs.blend_mode;
    rp.smask = gs.smask;
    if (stroke && !gs.dash.empty()) {
      // dash lengths are user-space: scale by the same ctm factor the
      // line width uses, then split the polylines into "on" runs
      std::vector<double> pat(gs.dash);
      for (double& v : pat) v *= sc;
      auto dashed = dash_polylines(subpaths, pat, gs.dash_phase * sc);
      if (fill) {
        // fill keeps the full outline; the stroke gets its own item
        RenderPath srp = rp;
        srp.fill = false;
        srp.subpaths = std::move(dashed);
        rp.stroke = false;
        dl->order_kind.push_back(0);
        dl->order_index.push_back((int)dl->paths.size());
        dl->paths.push_back(std::move(srp));
      } else {
        rp.subpaths = std::move(dashed);
      }
    }
    if (rp.fill || rp.stroke) {  // may be shading-only (fill cleared above)
      dl->order_kind.push_back(0);
      dl->order_index.push_back((int)dl->paths.size());
      dl->paths.push_back(std::move(rp));
    }
  }
  if (pending_clip) {
    // approximate: intersect clip with path bbox
    gs.clip.x0 = std::max(gs.clip.x0, bb.x0);
    gs.clip.y0 = std::max(gs.clip.y0, bb.y0);
    gs.clip.x1 = std::min(gs.clip.x1, bb.x1);
    gs.clip.y1 = std::min(gs.clip.y1, bb.y1);
    pending_clip = false;
  }
  subpaths.clear();
}

void Interp::do_xobject(const std::string& name, const ObjPtr& resources) {
  ObjPtr xobjs = doc->dict_get(resources, "XObject");
  ObjPtr xo;
  int obj_num = 0;
  if (xobjs->is(ObjType::Dict)) {
    auto it = xobjs->dict.find(name);
    if (it != xobjs->dict.end()) {
      if (it->second->is(ObjType::Ref)) obj_num = it->second->ref_num;
      xo = doc->resolve(it->second);
    }
  }
  if (!xo || !xo->is(ObjType::Stream)) return;
  ObjPtr st = doc->dict_get(xo, "Subtype");
  if (st->s == "Image") {
    ImagePlacement ip;
    ip.obj_num = obj_num;
    double x00, y00, x10, y10, x01, y01, x11, y11;
    gs.ctm.apply(0, 0, &x00, &y00);
    gs.ctm.apply(1, 0, &x10, &y10);
    gs.ctm.apply(0, 1, &x01, &y01);
    gs.ctm.apply(1, 1, &x11, &y11);
    ip.rect.grow(x00, y00);
    ip.rect.grow(x10, y10);
    ip.rect.grow(x01, y01);
    ip.rect.grow(x11, y11);
    ip.width = (int)doc->dict_get(xo, "Width")->num();
    ip.height = (int)doc->dict_get(xo, "Height")->num();
    out->images.push_back(ip);
    // xobjects may carry their own /OC entry (watermark layers)
    ObjPtr xoc = doc->dict_get(xo, "OC");
    if (suppressed() || (!xoc->is(ObjType::Null) && ocg_hidden(xoc)))
      return;
    RenderImage ri;
    ri.obj_num = obj_num;
    ri.img_to_page = gs.ctm;
    ri.clip = gs.clip;
    ri.const_alpha = gs.fill_alpha;
    ri.blend_mode = gs.blend_mode;
    ri.smask = gs.smask;
    ObjPtr imask = doc->dict_get(xo, "ImageMask");
    if (imask->is(ObjType::Bool) && imask->b) {
      ri.stencil = true;
      for (int k = 0; k < 3; k++) ri.stencil_rgb[k] = gs.fill_rgb[k];
    }
    dl->order_kind.push_back(2);
    dl->order_index.push_back((int)dl->images.size());
    dl->images.push_back(std::move(ri));
  } else if (st->s == "Form" && depth < 12) {
    ObjPtr mtx = doc->dict_get(xo, "Matrix");
    GState saved = gs;
    if (mtx->is(ObjType::Array) && mtx->arr.size() == 6) {
      Matrix m{doc->resolve(mtx->arr[0])->num(), doc->resolve(mtx->arr[1])->num(),
               doc->resolve(mtx->arr[2])->num(), doc->resolve(mtx->arr[3])->num(),
               doc->resolve(mtx->arr[4])->num(), doc->resolve(mtx->arr[5])->num()};
      gs.ctm = m.mul(gs.ctm);
    }
    ObjPtr res2 = doc->dict_get(xo, "Resources");
    if (!res2->is(ObjType::Dict)) res2 = resources;
    depth++;
    run_stream(doc->decode_stream(xo), res2);
    depth--;
    gs = saved;
  }
}

void Interp::run_stream(const std::string& content, const ObjPtr& resources) {
  Lexer lx((const uint8_t*)content.data(), content.size());
  std::vector<ObjPtr> st;
  auto num = [&](int idx) -> double {
    int k = (int)st.size() - idx;
    return k >= 0 && k < (int)st.size() ? st[k]->num() : 0.0;
  };
  while (!lx.eof()) {
    lx.skip_ws();
    if (lx.eof()) break;
    uint8_t c = ((const uint8_t*)content.data())[lx.pos()];
    if (c == '/' || c == '[' || c == '(' || c == '<' ||
        (c >= '0' && c <= '9') || c == '+' || c == '-' || c == '.') {
      st.push_back(lx.parse_object());
      if (st.size() > 64) st.erase(st.begin());
      continue;
    }
    std::string op = lx.next_keyword();
    if (op.empty()) {
      lx.seek(lx.pos() + 1);
      continue;
    }
    // --- graphics state
    if (op == "q") {
      gstack.push_back(gs);
    } else if (op == "Q") {
      if (!gstack.empty()) {
        gs = gstack.back();
        gstack.pop_back();
      }
    } else if (op == "cm" && st.size() >= 6) {
      Matrix m{num(6), num(5), num(4), num(3), num(2), num(1)};
      gs.ctm = m.mul(gs.ctm);
    } else if (op == "w") {
      gs.line_width = num(1);
    } else if (op == "d") {
      // dash pattern: [array] phase d
      gs.dash.clear();
      gs.dash_phase = 0;
      if (st.size() >= 2 && st[st.size() - 2]->is(ObjType::Array)) {
        for (auto& el : st[st.size() - 2]->arr)
          gs.dash.push_back(doc->resolve(el)->num());
        gs.dash_phase = num(1);
        bool any_on = false;
        for (double v : gs.dash) any_on |= v > 0;
        if (!any_on) gs.dash.clear();  // empty/zero array = solid
      }
    } else if (op == "gs") {
      // ExtGState: honor the entries that change pixels we care about —
      // /ca //CA constant alpha (matplotlib's alpha= fills emit these;
      // rendering them opaque hid gridlines/series underneath), /LW,
      // /D dash, /BM blend modes, and /SMask soft-mask groups.
      if (!st.empty() && st.back()->is(ObjType::Name)) {
        ObjPtr egs_dict = doc->dict_get(resources, "ExtGState");
        ObjPtr egs = egs_dict->is(ObjType::Dict)
                         ? doc->dict_get(egs_dict, st.back()->s)
                         : make_null();
        if (egs->is(ObjType::Dict)) {
          ObjPtr ca = doc->dict_get(egs, "ca");
          if (ca->is(ObjType::Int) || ca->is(ObjType::Real))
            gs.fill_alpha = (float)std::min(std::max(ca->num(), 0.0), 1.0);
          ObjPtr CA = doc->dict_get(egs, "CA");
          if (CA->is(ObjType::Int) || CA->is(ObjType::Real))
            gs.stroke_alpha = (float)std::min(std::max(CA->num(), 0.0), 1.0);
          ObjPtr lw = doc->dict_get(egs, "LW");
          if (lw->is(ObjType::Int) || lw->is(ObjType::Real))
            gs.line_width = lw->num();
          ObjPtr dd = doc->dict_get(egs, "D");
          if (dd->is(ObjType::Array) && dd->arr.size() >= 2) {
            ObjPtr pat = doc->resolve(dd->arr[0]);
            gs.dash.clear();
            if (pat->is(ObjType::Array))
              for (auto& el : pat->arr)
                gs.dash.push_back(doc->resolve(el)->num());
            gs.dash_phase = doc->resolve(dd->arr[1])->num();
            bool any_on = false;
            for (double v : gs.dash) any_on |= v > 0;
            if (!any_on) gs.dash.clear();
          }
          ObjPtr bm = doc->dict_get(egs, "BM");
          if (bm->is(ObjType::Array) && !bm->arr.empty())
            bm = doc->resolve(bm->arr[0]);  // first mode the viewer knows
          if (bm->is(ObjType::Name)) {
            static const char* kModes[] = {
                "Normal", "Multiply", "Screen", "Overlay", "Darken",
                "Lighten", "ColorDodge", "ColorBurn", "HardLight",
                "SoftLight", "Difference", "Exclusion", "Hue",
                "Saturation", "Color", "Luminosity"};
            int mode = 0;  // unknown names fall back to Normal (spec)
            for (int k = 0; k < 16; k++)
              if (bm->s == kModes[k]) {
                mode = k;
                break;
              }
            if (mode != gs.blend_mode) flush_span();
            gs.blend_mode = mode;
          }
          ObjPtr smv = doc->dict_get(egs, "SMask");
          if (smv->is(ObjType::Name) && smv->s == "None") {
            if (gs.smask) flush_span();
            gs.smask = nullptr;
          } else if (smv->is(ObjType::Dict)) {
            flush_span();
            gs.smask = build_softmask(smv);
          }
        }
      }
    } else if (op == "ri" || op == "i" || op == "j" ||
               op == "J" || op == "M") {
      // ignored state ops
    }
    // --- color
    // g/rg/k implicitly select DeviceGray/RGB/CMYK (PDF 8.6.8), which
    // also ends any active pattern fill — real streams switch back from
    // `/Pattern cs /P scn` with a plain `rg` and expect the flat color
    else if (op == "rg" && st.size() >= 3) {
      gs.fill_rgb[0] = (float)num(3);
      gs.fill_rgb[1] = (float)num(2);
      gs.fill_rgb[2] = (float)num(1);
      gs.fill_cs = CsKind::Rgb;
      gs.fill_cs_pattern = false;
      gs.fill_pattern_shading = nullptr;
      gs.fill_tile_dl = nullptr;
    } else if (op == "RG" && st.size() >= 3) {
      gs.stroke_rgb[0] = (float)num(3);
      gs.stroke_rgb[1] = (float)num(2);
      gs.stroke_rgb[2] = (float)num(1);
      gs.stroke_cs = CsKind::Rgb;
    } else if (op == "g") {
      gs.fill_rgb[0] = gs.fill_rgb[1] = gs.fill_rgb[2] = (float)num(1);
      gs.fill_cs = CsKind::Gray;
      gs.fill_cs_pattern = false;
      gs.fill_pattern_shading = nullptr;
      gs.fill_tile_dl = nullptr;
    } else if (op == "G") {
      gs.stroke_rgb[0] = gs.stroke_rgb[1] = gs.stroke_rgb[2] = (float)num(1);
      gs.stroke_cs = CsKind::Gray;
    } else if (op == "k" && st.size() >= 4) {
      double kk = num(1);
      gs.fill_rgb[0] = (float)((1 - num(4)) * (1 - kk));
      gs.fill_rgb[1] = (float)((1 - num(3)) * (1 - kk));
      gs.fill_rgb[2] = (float)((1 - num(2)) * (1 - kk));
      gs.fill_cs = CsKind::Cmyk;
      gs.fill_cs_pattern = false;
      gs.fill_pattern_shading = nullptr;
      gs.fill_tile_dl = nullptr;
    } else if (op == "K" && st.size() >= 4) {
      double kk = num(1);
      gs.stroke_rgb[0] = (float)((1 - num(4)) * (1 - kk));
      gs.stroke_rgb[1] = (float)((1 - num(3)) * (1 - kk));
      gs.stroke_rgb[2] = (float)((1 - num(2)) * (1 - kk));
    } else if (op == "sc" || op == "scn") {
      if (op == "scn" && !st.empty() && st.back()->is(ObjType::Name) &&
          gs.fill_cs_pattern) {
        // pattern fill: /P0 scn — resolve from the Pattern resources
        gs.fill_pattern_shading = nullptr;
      gs.fill_tile_dl = nullptr;
        ObjPtr pats = doc->dict_get(resources, "Pattern");
        ObjPtr pat = pats->is(ObjType::Dict)
                         ? doc->dict_get(pats, st.back()->s)
                         : make_null();
        if (pat->is(ObjType::Dict) || pat->is(ObjType::Stream)) {
          int ptype = (int)doc->dict_get(pat, "PatternType")->num();
          Matrix pm;  // pattern space -> page default space
          ObjPtr pmtx = doc->dict_get(pat, "Matrix");
          if (pmtx->is(ObjType::Array) && pmtx->arr.size() == 6)
            pm = Matrix{doc->resolve(pmtx->arr[0])->num(),
                        doc->resolve(pmtx->arr[1])->num(),
                        doc->resolve(pmtx->arr[2])->num(),
                        doc->resolve(pmtx->arr[3])->num(),
                        doc->resolve(pmtx->arr[4])->num(),
                        doc->resolve(pmtx->arr[5])->num()};
          if (ptype == 2) {
            gs.fill_pattern_shading = doc->dict_get(pat, "Shading");
            gs.fill_pattern_mtx = pm.mul(base_ctm);
          } else if (ptype == 1 && pat->is(ObjType::Stream) &&
                     build_tile_pattern(pat, pm)) {
            // tiling pattern (hatched chart fills): cell interpreted
            // into its own display list inside build_tile_pattern
          } else {
            // unknown pattern type / malformed cell: graceful degrade —
            // fill mid-gray so the region keeps ink for detection
            gs.fill_rgb[0] = gs.fill_rgb[1] = gs.fill_rgb[2] = 0.5f;
          }
        }
      } else {
        // numeric operands interpreted per the ACTIVE colorspace: count
        // the trailing numeric run (scn may carry a /Name after tints)
        size_t nops = 0;
        while (nops < st.size() &&
               (st[st.size() - 1 - nops]->is(ObjType::Real) ||
                st[st.size() - 1 - nops]->is(ObjType::Int)))
          nops++;
        if (nops >= 1) {
          gs.fill_pattern_shading = nullptr;
          gs.fill_tile_dl = nullptr;
          std::vector<double> tints;
          for (size_t k = nops; k >= 1; k--) tints.push_back(num((int)k));
          if (!(gs.fill_cs == CsKind::Sep &&
                sep_exact_rgb(doc, gs.fill_cs_obj, tints, gs.fill_rgb)))
            operands_to_rgb(gs.fill_cs, nops, num, gs.fill_rgb);
        }
      }
    } else if (op == "SC" || op == "SCN") {
      size_t nops = 0;
      while (nops < st.size() &&
             (st[st.size() - 1 - nops]->is(ObjType::Real) ||
              st[st.size() - 1 - nops]->is(ObjType::Int)))
        nops++;
      if (nops >= 1) {
        std::vector<double> tints;
        for (size_t k = nops; k >= 1; k--) tints.push_back(num((int)k));
        if (!(gs.stroke_cs == CsKind::Sep &&
              sep_exact_rgb(doc, gs.stroke_cs_obj, tints, gs.stroke_rgb)))
          operands_to_rgb(gs.stroke_cs, nops, num, gs.stroke_rgb);
      }
    } else if (op == "cs" || op == "CS") {
      // colorspace select: classify the family so sc/scn operands are
      // interpreted correctly (Separation tints, CMYK, ICC N); track
      // /Pattern (incl. [/Pattern base]) so scn name operands resolve
      if (!st.empty()) {
        // resolve named spaces once so Separation handling below can
        // reach the tint transform
        ObjPtr cs_obj = doc->resolve(st.back());
        if (cs_obj->is(ObjType::Name)) {
          ObjPtr csd = doc->dict_get(resources, "ColorSpace");
          if (csd->is(ObjType::Dict)) {
            ObjPtr ref = doc->dict_get(csd, cs_obj->s);
            if (!ref->is(ObjType::Null)) cs_obj = ref;
          }
        }
        CsKind kind = classify_cs(doc, resources, cs_obj);
        if (op == "cs") {
          gs.fill_cs = kind;
          gs.fill_cs_obj = cs_obj;
          gs.fill_cs_pattern = kind == CsKind::Pattern;
          if (!gs.fill_cs_pattern) {
            gs.fill_pattern_shading = nullptr;
            gs.fill_tile_dl = nullptr;
          }
        } else {
          gs.stroke_cs = kind;
          gs.stroke_cs_obj = cs_obj;
        }
      }
    } else if (op == "sh") {
      // paint the current clip with a shading (axial/radial supported)
      if (!st.empty() && st.back()->is(ObjType::Name) && !suppressed()) {
        ObjPtr shs = doc->dict_get(resources, "Shading");
        ObjPtr shd = shs->is(ObjType::Dict)
                         ? doc->dict_get(shs, st.back()->s)
                         : make_null();
        RenderShading rs;
        if (build_shading(doc, shd, gs.ctm, &rs)) {
          rs.clip = gs.clip;
          rs.blend_mode = gs.blend_mode;
          rs.smask = gs.smask;
          rs.const_alpha = gs.fill_alpha;
          dl->order_kind.push_back(3);
          dl->order_index.push_back((int)dl->shadings.size());
          dl->shadings.push_back(std::move(rs));
        }
      }
    }
    // --- path construction (page->device transform applied immediately)
    else if (op == "m" && st.size() >= 2) {
      subpaths.push_back({});
      double x, y;
      gs.ctm.apply(num(2), num(1), &x, &y);
      subpaths.back().push_back({(float)x, (float)y});
      cur_x = num(2);
      cur_y = num(1);
    } else if (op == "l" && st.size() >= 2) {
      if (subpaths.empty()) subpaths.push_back({});
      double x, y;
      gs.ctm.apply(num(2), num(1), &x, &y);
      subpaths.back().push_back({(float)x, (float)y});
      cur_x = num(2);
      cur_y = num(1);
    } else if ((op == "c" || op == "v" || op == "y")) {
      double x1, y1, x2, y2, x3, y3;
      if (op == "c" && st.size() >= 6) {
        x1 = num(6); y1 = num(5); x2 = num(4); y2 = num(3);
        x3 = num(2); y3 = num(1);
      } else if (op == "v" && st.size() >= 4) {
        x1 = cur_x; y1 = cur_y; x2 = num(4); y2 = num(3);
        x3 = num(2); y3 = num(1);
      } else if (op == "y" && st.size() >= 4) {
        x1 = num(4); y1 = num(3); x3 = num(2); y3 = num(1);
        x2 = x3; y2 = y3;
      } else {
        st.clear();
        continue;
      }
      if (subpaths.empty()) subpaths.push_back({});
      const int STEPS = 12;
      for (int k = 1; k <= STEPS; k++) {
        double t = (double)k / STEPS, u = 1 - t;
        double bx = u * u * u * cur_x + 3 * u * u * t * x1 +
                    3 * u * t * t * x2 + t * t * t * x3;
        double by = u * u * u * cur_y + 3 * u * u * t * y1 +
                    3 * u * t * t * y2 + t * t * t * y3;
        double dx, dy;
        gs.ctm.apply(bx, by, &dx, &dy);
        subpaths.back().push_back({(float)dx, (float)dy});
      }
      cur_x = x3;
      cur_y = y3;
    } else if (op == "re" && st.size() >= 4) {
      double x = num(4), y = num(3), w = num(2), h = num(1);
      std::vector<std::pair<float, float>> r;
      double dx, dy;
      gs.ctm.apply(x, y, &dx, &dy);
      r.push_back({(float)dx, (float)dy});
      gs.ctm.apply(x + w, y, &dx, &dy);
      r.push_back({(float)dx, (float)dy});
      gs.ctm.apply(x + w, y + h, &dx, &dy);
      r.push_back({(float)dx, (float)dy});
      gs.ctm.apply(x, y + h, &dx, &dy);
      r.push_back({(float)dx, (float)dy});
      gs.ctm.apply(x, y, &dx, &dy);
      r.push_back({(float)dx, (float)dy});
      subpaths.push_back(std::move(r));
      cur_x = x;
      cur_y = y;
    } else if (op == "h") {
      if (!subpaths.empty() && !subpaths.back().empty())
        subpaths.back().push_back(subpaths.back().front());
    }
    // --- path painting
    else if (op == "S") paint_path(false, true, false);
    else if (op == "s") {
      if (!subpaths.empty() && !subpaths.back().empty())
        subpaths.back().push_back(subpaths.back().front());
      paint_path(false, true, false);
    } else if (op == "f" || op == "F") paint_path(true, false, false);
    else if (op == "f*") paint_path(true, false, true);
    else if (op == "B") paint_path(true, true, false);
    else if (op == "B*") paint_path(true, true, true);
    else if (op == "b") {
      if (!subpaths.empty() && !subpaths.back().empty())
        subpaths.back().push_back(subpaths.back().front());
      paint_path(true, true, false);
    } else if (op == "b*") {
      if (!subpaths.empty() && !subpaths.back().empty())
        subpaths.back().push_back(subpaths.back().front());
      paint_path(true, true, true);
    } else if (op == "n") paint_path(false, false, false);
    else if (op == "W") pending_clip = true;
    else if (op == "W*") {
      pending_clip = true;
      pending_clip_eo = true;
    }
    // --- text
    else if (op == "BT") {
      in_text = true;
      tm = Matrix::identity();
      tlm = tm;
    } else if (op == "ET") {
      in_text = false;
      flush_span();
    } else if (op == "Tf" && st.size() >= 2) {
      std::string fname = st[st.size() - 2]->s;
      gs.font_size = num(1);
      auto it = font_cache.find(fname);
      if (it != font_cache.end()) {
        gs.font = it->second;
      } else {
        ObjPtr fonts = doc->dict_get(resources, "Font");
        // doc-level cache by the font dict's OBJECT NUMBER (the raw,
        // unresolved Ref): font programs parse once per document, not
        // once per page
        int fnum = 0;
        if (fonts->is(ObjType::Dict)) {
          auto raw = fonts->dict.find(fname);
          if (raw != fonts->dict.end() && raw->second->is(ObjType::Ref))
            fnum = raw->second->ref_num;
        }
        if (fnum) {
          auto dit = doc->font_cache.find(fnum);
          if (dit != doc->font_cache.end()) {
            gs.font = dit->second;
            font_cache[fname] = gs.font;
          }
        }
        if (!gs.font || font_cache.find(fname) == font_cache.end()) {
          ObjPtr fd = doc->dict_get(fonts, fname);
          if (fd->is(ObjType::Dict)) {
            gs.font = load_font(doc, fd);
            font_cache[fname] = gs.font;
            if (fnum) doc->font_cache[fnum] = gs.font;
          }
        }
      }
    } else if (op == "Td" && st.size() >= 2) {
      Matrix t{1, 0, 0, 1, num(2), num(1)};
      tlm = t.mul(tlm);
      tm = tlm;
    } else if (op == "TD" && st.size() >= 2) {
      gs.leading = -num(1);
      Matrix t{1, 0, 0, 1, num(2), num(1)};
      tlm = t.mul(tlm);
      tm = tlm;
    } else if (op == "Tm" && st.size() >= 6) {
      tlm = Matrix{num(6), num(5), num(4), num(3), num(2), num(1)};
      tm = tlm;
    } else if (op == "T*") {
      Matrix t{1, 0, 0, 1, 0, -gs.leading};
      tlm = t.mul(tlm);
      tm = tlm;
    } else if (op == "TL") {
      gs.leading = num(1);
    } else if (op == "Tc") {
      gs.char_spacing = num(1);
    } else if (op == "Tw") {
      gs.word_spacing = num(1);
    } else if (op == "Tz") {
      gs.horiz_scale = num(1) / 100.0;
    } else if (op == "Ts") {
      gs.rise = num(1);
    } else if (op == "Tr") {
      gs.render_mode = (int)num(1);
    } else if (op == "Tj" && !st.empty()) {
      op_show_text(st.back()->s, resources);
    } else if (op == "'" && !st.empty()) {
      Matrix t{1, 0, 0, 1, 0, -gs.leading};
      tlm = t.mul(tlm);
      tm = tlm;
      op_show_text(st.back()->s, resources);
    } else if (op == "\"" && st.size() >= 3) {
      gs.word_spacing = num(3);
      gs.char_spacing = num(2);
      Matrix t{1, 0, 0, 1, 0, -gs.leading};
      tlm = t.mul(tlm);
      tm = tlm;
      op_show_text(st.back()->s, resources);
    } else if (op == "TJ" && !st.empty() && st.back()->is(ObjType::Array)) {
      for (auto& el : st.back()->arr) {
        if (el->is(ObjType::String)) {
          op_show_text(el->s, resources);
        } else {
          double adj = -el->num() / 1000.0 * gs.font_size * gs.horiz_scale;
          Matrix t{1, 0, 0, 1, adj, 0};
          tm = t.mul(tm);
        }
      }
    }
    // --- xobjects & inline images
    else if (op == "Do" && !st.empty()) {
      flush_span();
      do_xobject(st.back()->s, resources);
    } else if (op == "BI") {
      // inline image: parse key/value pairs until ID, then raw data to EI
      ObjPtr d = std::make_shared<Object>();
      d->type = ObjType::Dict;
      while (!lx.eof()) {
        lx.skip_ws();
        if (lx.peek_keyword("ID")) {
          lx.next_keyword();
          break;
        }
        ObjPtr k = lx.parse_object();
        ObjPtr v = lx.parse_object();
        if (k->is(ObjType::Name)) d->dict[k->s] = v;
      }
      size_t p = lx.pos();
      if (p < content.size() && (content[p] == ' ' || content[p] == '\n' ||
                                 content[p] == '\r'))
        p++;
      // find EI delimiter
      size_t q = p;
      while (q + 2 < content.size()) {
        if (content[q] == 'E' && content[q + 1] == 'I' &&
            (q + 2 >= content.size() || isspace((uint8_t)content[q + 2])))
          break;
        q++;
      }
      lx.seek(std::min(q + 2, content.size()));
      ImagePlacement ip;
      ip.inline_image = true;
      double x00, y00, x11, y11;
      gs.ctm.apply(0, 0, &x00, &y00);
      gs.ctm.apply(1, 1, &x11, &y11);
      ip.rect.grow(x00, y00);
      ip.rect.grow(x11, y11);
      auto getk = [&](const char* a, const char* b) -> ObjPtr {
        auto it = d->dict.find(a);
        if (it == d->dict.end()) it = d->dict.find(b);
        return it == d->dict.end() ? make_null() : it->second;
      };
      ip.width = (int)getk("Width", "W")->num();
      ip.height = (int)getk("Height", "H")->num();
      out->images.push_back(ip);
      // rasterize: normalize abbreviated keys into a pseudo stream
      // object so the XObject decode machinery applies unchanged
      // (decode_stream already accepts abbreviated filter names, and
      // obj_num 0 correctly skips decryption — inline data arrives
      // already decrypted inside the content stream)
      if (p < q && ip.width > 0 && ip.height > 0) {
        auto norm = std::make_shared<Object>();
        norm->type = ObjType::Stream;
        norm->stream_raw.assign(content.data() + p, q - p);
        static const std::pair<const char*, const char*> kAbbrev[] = {
            {"W", "Width"},       {"H", "Height"},
            {"BPC", "BitsPerComponent"}, {"CS", "ColorSpace"},
            {"F", "Filter"},      {"DP", "DecodeParms"},
            {"IM", "ImageMask"},  {"D", "Decode"},
        };
        for (auto& kv : d->dict) {
          std::string key = kv.first;
          for (auto& ab : kAbbrev)
            if (key == ab.first) { key = ab.second; break; }
          norm->dict[key] = kv.second;
        }
        RenderImage ri;
        ri.inline_image = true;
        ri.img_to_page = gs.ctm;
        ri.clip = gs.clip;
        ri.blend_mode = gs.blend_mode;
        ri.smask = gs.smask;
        ObjPtr imask = doc->dict_get(norm, "ImageMask");
        if (imask->is(ObjType::Bool) && imask->b) {
          ri.stencil = true;
          for (int k = 0; k < 3; k++) ri.stencil_rgb[k] = gs.fill_rgb[k];
          ri.inline_alpha = decode_image_alpha(doc, norm, &ri.inline_aw,
                                               &ri.inline_ah);
          ri.inline_w = ri.inline_aw;
          ri.inline_h = ri.inline_ah;
        } else {
          ri.inline_rgb = decode_image_rgb_obj(doc, norm, &ri.inline_w,
                                               &ri.inline_h);
        }
        if ((!ri.inline_rgb.empty() || !ri.inline_alpha.empty()) &&
            !suppressed()) {
          dl->order_kind.push_back(2);
          dl->order_index.push_back((int)dl->images.size());
          dl->images.push_back(std::move(ri));
        }
      }
      st.clear();
      continue;
    } else if (op == "BDC" || op == "BMC") {
      bool hide = false;
      if (op == "BDC" && st.size() >= 2) {
        ObjPtr tag = st[st.size() - 2];
        ObjPtr props = st.back();
        if (tag->is(ObjType::Name) && tag->s == "OC" &&
            !hidden_ocgs.empty()) {
          if (props->is(ObjType::Name)) {
            ObjPtr pd = doc->dict_get(resources, "Properties");
            if (pd->is(ObjType::Dict))
              props = doc->dict_get(pd, props->s);
          }
          hide = ocg_hidden(props);
        }
      }
      mc_stack.push_back(hide);
      if (hide) mc_suppressed++;
    } else if (op == "EMC") {
      if (!mc_stack.empty()) {
        if (mc_stack.back()) mc_suppressed--;
        mc_stack.pop_back();
      }
    } else if (op == "BX" || op == "EX" || op == "MP" || op == "DP") {
      // marked content points: ignore
    }
    st.clear();
  }
}

// ---------------------------------------------------------------------------
// Annotation appearance synthesis (annots WITHOUT /AP). MuPDF renders
// these too: its pdf_appearance.c synthesizes an appearance stream from
// the annotation dictionary's geometry/color entries, so fitz
// get_pixmap (the reference render path, pdf_image_segmentation.py:3651)
// shows them. We emit a content-stream string directly in PAGE space
// (no 12.5.5 form mapping needed) for the standard geometry/markup
// subtypes, FreeText (/DA-styled, wrapped, quadded text), Stamp
// (rounded banner with the /Name as text), and Widget fields (/MK
// decoration, /Tx value text, /Btn check marks); exotic field types
// (signatures) stay a documented degrade; /Ch presents like /Tx.
// ---------------------------------------------------------------------------

static void syn_num(std::string* s, double v) {
  char b[40];
  snprintf(b, sizeof b, "%.4f ", v);
  *s += b;
}

// /C //IC color arrays: 0 comps = none, 1 = gray, 3 = RGB, 4 = CMYK
// (PDF 32000-1 12.5.6.2)
static bool syn_color(Document* doc, const ObjPtr& an, const char* key,
                      bool stroke, std::string* s) {
  ObjPtr c = doc->dict_get(an, key);
  if (!c->is(ObjType::Array)) return false;
  std::vector<double> v;
  for (auto& e : c->arr) v.push_back(doc->resolve(e)->num());
  if (v.empty()) return false;
  for (double x : v) syn_num(s, std::min(1.0, std::max(0.0, x)));
  if (v.size() >= 4) *s += stroke ? "K\n" : "k\n";
  else if (v.size() >= 3) *s += stroke ? "RG\n" : "rg\n";
  else *s += stroke ? "G\n" : "g\n";
  return true;
}

static double syn_border_width(Document* doc, const ObjPtr& an) {
  ObjPtr bs = doc->dict_get(an, "BS");
  if (bs->is(ObjType::Dict)) {
    ObjPtr w = doc->dict_get(bs, "W");
    if (w->is(ObjType::Int) || w->is(ObjType::Real))
      return std::max(0.0, w->num());
  }
  ObjPtr br = doc->dict_get(an, "Border");
  if (br->is(ObjType::Array) && br->arr.size() >= 3)
    return std::max(0.0, doc->resolve(br->arr[2])->num());
  return 1.0;  // PDF 12.5.4: default border width
}

// /QuadPoints -> per-quad AABBs. Producers famously disagree on the
// corner order (the spec's counterclockwise wording vs Acrobat's
// TL TR BL BR emission), so the AABB is the robust interpretation for
// the axis-aligned quads text markup produces.
static std::vector<std::array<double, 4>> syn_quads(Document* doc,
                                                    const ObjPtr& an) {
  std::vector<std::array<double, 4>> out;
  ObjPtr q = doc->dict_get(an, "QuadPoints");
  if (!q->is(ObjType::Array)) return out;
  for (size_t i = 0; i + 7 < q->arr.size(); i += 8) {
    double xs[4], ys[4];
    for (int k = 0; k < 4; k++) {
      xs[k] = doc->resolve(q->arr[i + 2 * k])->num();
      ys[k] = doc->resolve(q->arr[i + 2 * k + 1])->num();
    }
    double x0 = *std::min_element(xs, xs + 4);
    double x1 = *std::max_element(xs, xs + 4);
    double y0 = *std::min_element(ys, ys + 4);
    double y1 = *std::max_element(ys, ys + 4);
    if (x1 > x0 && y1 > y0) out.push_back({x0, y0, x1, y1});
  }
  return out;
}

static ObjPtr syn_ensure_res(ObjPtr* res_out) {
  if (!(*res_out) || !(*res_out)->is(ObjType::Dict)) {
    auto r = std::make_shared<Object>();
    r->type = ObjType::Dict;
    *res_out = r;
  }
  return *res_out;
}

// PDF text string (12.5.6 /Contents): UTF-16BE with BOM, else PDFDoc
// bytes (≈ Latin-1 for the printable range WinAnsi also covers)
static std::string syn_text_decode(const std::string& s) {
  if (s.size() >= 2 && (uint8_t)s[0] == 0xFE && (uint8_t)s[1] == 0xFF) {
    std::string out;
    for (size_t i = 2; i + 1 < s.size(); i += 2) {
      uint32_t u = ((uint8_t)s[i] << 8) | (uint8_t)s[i + 1];
      out += (u && u < 256) ? (char)u : '?';
    }
    return out;
  }
  return s;
}

static void syn_escape(std::string* s, const std::string& text) {
  for (char c : text) {
    if (c == '(' || c == ')' || c == '\\') *s += '\\';
    *s += c;
  }
}

// /DA default-appearance string (12.7.3.3): extract the /<font> <size> Tf
// selector and any g/rg/k fill color so the synthesized text matches.
static void syn_parse_da(const std::string& da, std::string* font_name,
                         double* size, std::string* color_ops) {
  std::vector<std::string> t;
  std::string cur;
  for (char c : da) {
    if (isspace((unsigned char)c)) {
      if (!cur.empty()) {
        t.push_back(cur);
        cur.clear();
      }
    } else {
      cur += c;
    }
  }
  if (!cur.empty()) t.push_back(cur);
  for (size_t i = 0; i < t.size(); i++) {
    if (t[i] == "Tf" && i >= 2) {
      *size = atof(t[i - 1].c_str());
      *font_name = t[i - 2];
      if (!font_name->empty() && (*font_name)[0] == '/')
        font_name->erase(0, 1);
    } else if (t[i] == "g" && i >= 1) {
      *color_ops = t[i - 1] + " g\n";
    } else if (t[i] == "rg" && i >= 3) {
      *color_ops = t[i - 3] + " " + t[i - 2] + " " + t[i - 1] + " rg\n";
    } else if (t[i] == "k" && i >= 4) {
      *color_ops = t[i - 4] + " " + t[i - 3] + " " + t[i - 2] + " " +
                   t[i - 1] + " k\n";
    }
  }
}

// DA font names (/Helv /TiRo /Cour ...) resolve through the AcroForm
// default resources when present; otherwise fabricate a non-embedded
// base-14-style dict so load_font falls through to the family substitute
// (the same path non-embedded page fonts take).
static ObjPtr syn_resolve_da_font(Document* doc, const std::string& name) {
  if (!name.empty()) {
    ObjPtr root = doc->dict_get(doc->trailer(), "Root");
    ObjPtr dr = doc->dict_get(doc->dict_get(root, "AcroForm"), "DR");
    ObjPtr f = doc->dict_get(doc->dict_get(dr, "Font"), name);
    if (f->is(ObjType::Dict)) return f;
  }
  std::string lower;
  for (char c : name) lower += (char)tolower((unsigned char)c);
  const char* base = "Helvetica";
  if (lower.find("cour") != std::string::npos ||
      lower.find("mono") != std::string::npos)
    base = "Courier";
  else if (lower.find("tiro") != std::string::npos ||
           lower.find("times") != std::string::npos ||
           lower.find("serif") != std::string::npos ||
           lower.find("roman") != std::string::npos)
    base = "Times-Roman";
  else if (lower.find("bold") != std::string::npos)
    base = "Helvetica-Bold";
  auto f = std::make_shared<Object>();
  f->type = ObjType::Dict;
  f->dict["Type"] = make_name("Font");
  f->dict["Subtype"] = make_name("Type1");
  f->dict["BaseFont"] = make_name(base);
  return f;
}

static double syn_text_width(const PdfFont* f, const std::string& line,
                             double size) {
  double w = 0;
  for (unsigned char c : line) w += f->width_for_code(c) * size / 1000.0;
  return w;
}

// /C as an RGB triple (gray / rgb / cmyk comps per 12.5.6.2)
static bool syn_get_rgb(Document* doc, const ObjPtr& an, const char* key,
                        double* r, double* g, double* b) {
  ObjPtr c = doc->dict_get(an, key);
  if (!c->is(ObjType::Array)) return false;
  std::vector<double> v;
  for (auto& e : c->arr)
    v.push_back(std::min(1.0, std::max(0.0, doc->resolve(e)->num())));
  if (v.empty()) return false;
  if (v.size() >= 4) {
    *r = (1 - v[0]) * (1 - v[3]);
    *g = (1 - v[1]) * (1 - v[3]);
    *b = (1 - v[2]) * (1 - v[3]);
  } else if (v.size() >= 3) {
    *r = v[0];
    *g = v[1];
    *b = v[2];
  } else {
    *r = *g = *b = v[0];
  }
  return true;
}

// AcroForm field attribute with 12.7.3.1 inheritance via /Parent
static ObjPtr field_inherited(Document* doc, ObjPtr an, const char* key) {
  for (int d = 0; d < 8 && an->is(ObjType::Dict); d++) {
    ObjPtr v = doc->dict_get(an, key);
    if (!v->is(ObjType::Null)) return v;
    an = doc->dict_get(an, "Parent");
  }
  return make_null();
}

// Returns false when the subtype isn't synthesizable or carries no ink.
// pad_out = how far stroke ink may extend beyond /Rect (clip slop).
static bool synth_annot_appearance(Document* doc, const ObjPtr& an,
                                   const std::string& sub, double rx0,
                                   double ry0, double rx1, double ry1,
                                   std::string* content, ObjPtr* res_out,
                                   double* pad_out) {
  std::string s;
  double bw = syn_border_width(doc, an);
  *pad_out = bw;
  // markup opacity /CA and the Highlight multiply blend ride a
  // fabricated ExtGState the interpreter already evaluates
  double alpha = 1.0;
  ObjPtr cao = doc->dict_get(an, "CA");
  if (cao->is(ObjType::Int) || cao->is(ObjType::Real))
    alpha = std::min(1.0, std::max(0.0, cao->num()));
  bool multiply = (sub == "Highlight");
  if (alpha < 1.0 || multiply) {
    auto egs = std::make_shared<Object>();
    egs->type = ObjType::Dict;
    if (alpha < 1.0) {
      egs->dict["ca"] = make_real(alpha);
      egs->dict["CA"] = make_real(alpha);
    }
    if (multiply) egs->dict["BM"] = make_name("Multiply");
    auto gsd = std::make_shared<Object>();
    gsd->type = ObjType::Dict;
    gsd->dict["synA"] = egs;
    syn_ensure_res(res_out)->dict["ExtGState"] = gsd;
    s += "/synA gs\n";
  }

  if (sub == "Square" || sub == "Circle") {
    bool has_fill = syn_color(doc, an, "IC", false, &s);
    bool has_stroke = syn_color(doc, an, "C", true, &s);
    syn_num(&s, bw);
    s += "w\n";
    bool stroke = has_stroke && bw > 0;
    // per 12.5.6.8: no /C -> no border ink; no /IC -> no interior
    if (!stroke && !has_fill) return false;
    double in2 = stroke ? bw / 2 : 0;  // inset: ink stays inside /Rect
    double x0 = rx0 + in2, y0 = ry0 + in2, x1 = rx1 - in2, y1 = ry1 - in2;
    if (!(x1 > x0) || !(y1 > y0)) return false;
    if (sub == "Square") {
      syn_num(&s, x0); syn_num(&s, y0);
      syn_num(&s, x1 - x0); syn_num(&s, y1 - y0);
      s += "re\n";
    } else {
      const double kp = 0.55228474983;  // circular-arc Bezier constant
      double cx = (x0 + x1) / 2, cy = (y0 + y1) / 2;
      double ax = (x1 - x0) / 2, ay = (y1 - y0) / 2;
      syn_num(&s, cx + ax); syn_num(&s, cy); s += "m\n";
      syn_num(&s, cx + ax); syn_num(&s, cy + ay * kp);
      syn_num(&s, cx + ax * kp); syn_num(&s, cy + ay);
      syn_num(&s, cx); syn_num(&s, cy + ay); s += "c\n";
      syn_num(&s, cx - ax * kp); syn_num(&s, cy + ay);
      syn_num(&s, cx - ax); syn_num(&s, cy + ay * kp);
      syn_num(&s, cx - ax); syn_num(&s, cy); s += "c\n";
      syn_num(&s, cx - ax); syn_num(&s, cy - ay * kp);
      syn_num(&s, cx - ax * kp); syn_num(&s, cy - ay);
      syn_num(&s, cx); syn_num(&s, cy - ay); s += "c\n";
      syn_num(&s, cx + ax * kp); syn_num(&s, cy - ay);
      syn_num(&s, cx + ax); syn_num(&s, cy - ay * kp);
      syn_num(&s, cx + ax); syn_num(&s, cy); s += "c\nh\n";
    }
    s += (stroke && has_fill) ? "B\n" : (stroke ? "S\n" : "f\n");
  } else if (sub == "Line") {
    ObjPtr L = doc->dict_get(an, "L");
    if (!L->is(ObjType::Array) || L->arr.size() < 4) return false;
    if (!syn_color(doc, an, "C", true, &s)) s += "0 G\n";
    syn_num(&s, std::max(bw, 0.5));
    s += "w\n";
    syn_num(&s, doc->resolve(L->arr[0])->num());
    syn_num(&s, doc->resolve(L->arr[1])->num());
    s += "m\n";
    syn_num(&s, doc->resolve(L->arr[2])->num());
    syn_num(&s, doc->resolve(L->arr[3])->num());
    s += "l\nS\n";
  } else if (sub == "Ink") {
    ObjPtr inkl = doc->dict_get(an, "InkList");
    if (!inkl->is(ObjType::Array)) return false;
    if (!syn_color(doc, an, "C", true, &s)) s += "0 G\n";
    syn_num(&s, std::max(bw, 0.5));
    s += "w\n";
    bool any = false;
    for (auto& pref : inkl->arr) {
      ObjPtr pts = doc->resolve(pref);
      if (!pts->is(ObjType::Array) || pts->arr.size() < 4) continue;
      for (size_t i = 0; i + 1 < pts->arr.size(); i += 2) {
        syn_num(&s, doc->resolve(pts->arr[i])->num());
        syn_num(&s, doc->resolve(pts->arr[i + 1])->num());
        s += i == 0 ? "m\n" : "l\n";
      }
      s += "S\n";
      any = true;
    }
    if (!any) return false;
  } else if (sub == "Polygon" || sub == "PolyLine") {
    ObjPtr vs = doc->dict_get(an, "Vertices");
    if (!vs->is(ObjType::Array) || vs->arr.size() < 4) return false;
    bool has_fill =
        sub == "Polygon" && syn_color(doc, an, "IC", false, &s);
    if (!syn_color(doc, an, "C", true, &s)) s += "0 G\n";
    syn_num(&s, std::max(bw, 0.5));
    s += "w\n";
    for (size_t i = 0; i + 1 < vs->arr.size(); i += 2) {
      syn_num(&s, doc->resolve(vs->arr[i])->num());
      syn_num(&s, doc->resolve(vs->arr[i + 1])->num());
      s += i == 0 ? "m\n" : "l\n";
    }
    if (sub == "Polygon") s += has_fill ? "h\nB\n" : "h\nS\n";
    else s += "S\n";
  } else if (sub == "Highlight") {
    auto quads = syn_quads(doc, an);
    if (quads.empty()) return false;
    if (!syn_color(doc, an, "C", false, &s)) s += "1 1 0 rg\n";
    for (auto& q : quads) {
      syn_num(&s, q[0]); syn_num(&s, q[1]);
      syn_num(&s, q[2] - q[0]); syn_num(&s, q[3] - q[1]);
      s += "re\n";
    }
    s += "f\n";
  } else if (sub == "Underline" || sub == "StrikeOut" ||
             sub == "Squiggly") {
    auto quads = syn_quads(doc, an);
    if (quads.empty()) return false;
    if (!syn_color(doc, an, "C", true, &s)) s += "0 G\n";
    for (auto& q : quads) {
      double qh = q[3] - q[1];
      double lw = std::max(0.5, qh * 0.07);
      syn_num(&s, lw);
      s += "w\n";
      if (sub == "Squiggly") {
        double amp = qh * 0.12, half = std::max(1.0, qh * 0.2);
        double y = q[1] + amp;
        syn_num(&s, q[0]); syn_num(&s, y); s += "m\n";
        bool up = true;
        for (double x = q[0] + half; x < q[2] + half; x += half) {
          syn_num(&s, std::min(x, q[2]));
          syn_num(&s, up ? y + amp : y);
          s += "l\n";
          up = !up;
        }
        s += "S\n";
      } else {
        double y = sub == "Underline" ? q[1] + qh * 0.08 + lw / 2
                                      : q[1] + qh * 0.45;
        syn_num(&s, q[0]); syn_num(&s, y); s += "m\n";
        syn_num(&s, q[2]); syn_num(&s, y); s += "l\nS\n";
      }
    }
  } else if (sub == "FreeText") {
    // 12.5.6.6: for FreeText /C is the BACKGROUND; text style rides the
    // required /DA string (font selector, size, fill color honored).
    bool bg = syn_color(doc, an, "C", false, &s);
    if (bg) {
      syn_num(&s, rx0); syn_num(&s, ry0);
      syn_num(&s, rx1 - rx0); syn_num(&s, ry1 - ry0);
      s += "re\nf\n";
    }
    if (bw > 0 && rx1 - rx0 > bw * 2 && ry1 - ry0 > bw * 2) {
      s += "0 G\n";
      syn_num(&s, bw);
      s += "w\n";
      syn_num(&s, rx0 + bw / 2); syn_num(&s, ry0 + bw / 2);
      syn_num(&s, rx1 - rx0 - bw); syn_num(&s, ry1 - ry0 - bw);
      s += "re\nS\n";
    }
    std::string fname, colorops;
    double fsize = 0;
    ObjPtr dao = doc->dict_get(an, "DA");
    if (dao->is(ObjType::String))
      syn_parse_da(dao->s, &fname, &fsize, &colorops);
    if (fsize <= 0) fsize = 12;  // "/F 0 Tf" = auto-size: viewer floor
    if (colorops.empty()) colorops = "0 g\n";
    std::string text = syn_text_decode(doc->dict_get(an, "Contents")->s);
    bool any_text = false;
    double tpad = 2 + bw;
    double avail = rx1 - rx0 - 2 * tpad;
    if (!text.empty() && avail > fsize * 0.3) {
      ObjPtr fdict = syn_resolve_da_font(doc, fname);
      auto pf = load_font(doc, fdict);
      int q = 0;  // /Q quadding: 0 left / 1 center / 2 right (12.7.3.3)
      ObjPtr qo = doc->dict_get(an, "Q");
      if (qo->is(ObjType::Int) || qo->is(ObjType::Real)) q = (int)qo->num();
      // greedy word wrap at the measured substitute-font advances
      std::vector<std::string> lines;
      std::string cur;
      double curw = 0;
      auto flush_line = [&]() {
        while (!cur.empty() && cur.back() == ' ') cur.pop_back();
        lines.push_back(cur);
        cur.clear();
        curw = 0;
      };
      size_t i = 0;
      while (i < text.size()) {
        char c = text[i];
        if (c == '\r' || c == '\n') {
          if (c == '\r' && i + 1 < text.size() && text[i + 1] == '\n') i++;
          flush_line();
          i++;
          continue;
        }
        size_t j = i;
        if (c == ' ') {
          j = i + 1;
        } else {
          while (j < text.size() && text[j] != ' ' && text[j] != '\r' &&
                 text[j] != '\n')
            j++;
        }
        std::string word = text.substr(i, j - i);
        double ww = syn_text_width(pf.get(), word, fsize);
        if (!cur.empty() && word != " " && curw + ww > avail) flush_line();
        if (!(cur.empty() && word == " ")) {  // no leading spaces
          cur += word;
          curw += ww;
        }
        i = j;
      }
      if (!cur.empty()) flush_line();
      double lh = fsize * 1.15;
      double y = ry1 - tpad - fsize * 0.85;  // first baseline (~ascent)
      std::string ts;
      for (auto& ln : lines) {
        if (y < ry0 + tpad - 0.01) break;  // overflow clips at /Rect
        if (!ln.empty()) {
          double lwid = syn_text_width(pf.get(), ln, fsize);
          double x = rx0 + tpad;
          if (q == 1) x = rx0 + (rx1 - rx0 - lwid) / 2;
          else if (q == 2) x = rx1 - tpad - lwid;
          ts += "1 0 0 1 ";
          syn_num(&ts, x); syn_num(&ts, y);
          ts += "Tm\n(";
          syn_escape(&ts, ln);
          ts += ") Tj\n";
        }
        y -= lh;
      }
      if (!ts.empty()) {
        s += "BT\n/SynF ";
        syn_num(&s, fsize);
        s += "Tf\n" + colorops + ts + "ET\n";
        auto fres = std::make_shared<Object>();
        fres->type = ObjType::Dict;
        fres->dict["SynF"] = fdict;
        syn_ensure_res(res_out)->dict["Font"] = fres;
        any_text = true;
      }
    }
    if (!bg && bw <= 0 && !any_text) return false;
  } else if (sub == "Stamp") {
    // rubber stamp without /AP: rounded-rect banner with the camel-case
    // /Name as spaced uppercase text ("NotApproved" -> "NOT APPROVED"),
    // colored by the standard-name family like viewers' stamp artwork
    ObjPtr nm = doc->dict_get(an, "Name");
    std::string name = nm->is(ObjType::Name) ? nm->s : "Draft";
    std::string txt;
    for (char c : name) {
      if (isupper((unsigned char)c) && !txt.empty() && txt.back() != ' ')
        txt += ' ';
      txt += (char)toupper((unsigned char)c);
    }
    double rw = rx1 - rx0, rh = ry1 - ry0;
    if (rw < 8 || rh < 8) return false;
    double cr, cg, cb;
    if (!syn_get_rgb(doc, an, "C", &cr, &cg, &cb)) {
      static const char* kGreen[] = {"Approved", "Final", "Completed",
                                     "Confirmed"};
      static const char* kRed[] = {"NotApproved", "Void", "Rejected",
                                   "Cancelled"};
      cr = 0.04; cg = 0.25; cb = 0.6;  // default: annotation blue
      for (const char* g : kGreen)
        if (name == g) { cr = 0.0; cg = 0.45; cb = 0.1; }
      for (const char* rr : kRed)
        if (name == rr) { cr = 0.7; cg = 0.05; cb = 0.05; }
    }
    char cbuf[96];
    snprintf(cbuf, sizeof cbuf, "%.3f %.3f %.3f RG\n%.3f %.3f %.3f rg\n",
             cr, cg, cb, cr, cg, cb);
    s += cbuf;
    double blw = std::max(1.0, std::min(rw, rh) * 0.06);
    double x0 = rx0 + blw / 2, y0 = ry0 + blw / 2;
    double x1 = rx1 - blw / 2, y1 = ry1 - blw / 2;
    double r = std::min({(x1 - x0) / 4, (y1 - y0) / 4, rh * 0.2});
    const double kp = 0.55228474983;
    syn_num(&s, blw);
    s += "w\n";
    syn_num(&s, x0 + r); syn_num(&s, y0); s += "m\n";
    syn_num(&s, x1 - r); syn_num(&s, y0); s += "l\n";
    syn_num(&s, x1 - r + r * kp); syn_num(&s, y0);
    syn_num(&s, x1); syn_num(&s, y0 + r - r * kp);
    syn_num(&s, x1); syn_num(&s, y0 + r); s += "c\n";
    syn_num(&s, x1); syn_num(&s, y1 - r); s += "l\n";
    syn_num(&s, x1); syn_num(&s, y1 - r + r * kp);
    syn_num(&s, x1 - r + r * kp); syn_num(&s, y1);
    syn_num(&s, x1 - r); syn_num(&s, y1); s += "c\n";
    syn_num(&s, x0 + r); syn_num(&s, y1); s += "l\n";
    syn_num(&s, x0 + r - r * kp); syn_num(&s, y1);
    syn_num(&s, x0); syn_num(&s, y1 - r + r * kp);
    syn_num(&s, x0); syn_num(&s, y1 - r); s += "c\n";
    syn_num(&s, x0); syn_num(&s, y0 + r); s += "l\n";
    syn_num(&s, x0); syn_num(&s, y0 + r - r * kp);
    syn_num(&s, x0 + r - r * kp); syn_num(&s, y0);
    syn_num(&s, x0 + r); syn_num(&s, y0); s += "c\nh\nS\n";
    if (!txt.empty()) {
      ObjPtr fdict = syn_resolve_da_font(doc, "Helvetica-Bold");
      auto pf = load_font(doc, fdict);
      double unit = syn_text_width(pf.get(), txt, 1.0);
      double aw = (x1 - x0) - 2 * (blw + r * 0.4);
      double ah = (y1 - y0) - 2 * blw;
      double fs = ah * 0.55;
      if (unit > 0 && unit * fs > aw) fs = aw / unit;
      if (fs > 1 && unit > 0) {
        double tw = unit * fs;
        s += "BT\n/SynF ";
        syn_num(&s, fs);
        s += "Tf\n1 0 0 1 ";
        syn_num(&s, (x0 + x1) / 2 - tw / 2);
        syn_num(&s, (y0 + y1) / 2 - fs * 0.36);
        s += "Tm\n(";
        syn_escape(&s, txt);
        s += ") Tj\nET\n";
        auto fres = std::make_shared<Object>();
        fres->type = ObjType::Dict;
        fres->dict["SynF"] = fdict;
        syn_ensure_res(res_out)->dict["Font"] = fres;
      }
    }
  } else if (sub == "Widget") {
    // AcroForm field widget without /AP: /MK decoration + the field's
    // /V value rendered like a viewer's NeedAppearances regeneration
    // (12.7.3.3) — text fields and checkbox/radio buttons
    bool bg = false, bc = false;
    ObjPtr mk = doc->dict_get(an, "MK");
    if (mk->is(ObjType::Dict)) {
      bg = syn_color(doc, mk, "BG", false, &s);
      if (bg) {
        syn_num(&s, rx0); syn_num(&s, ry0);
        syn_num(&s, rx1 - rx0); syn_num(&s, ry1 - ry0);
        s += "re\nf\n";
      }
      bc = syn_color(doc, mk, "BC", true, &s);
      if (bc && bw > 0 && rx1 - rx0 > bw * 2 && ry1 - ry0 > bw * 2) {
        syn_num(&s, bw);
        s += "w\n";
        syn_num(&s, rx0 + bw / 2); syn_num(&s, ry0 + bw / 2);
        syn_num(&s, rx1 - rx0 - bw); syn_num(&s, ry1 - ry0 - bw);
        s += "re\nS\n";
      } else {
        bc = false;
      }
    }
    ObjPtr ft = field_inherited(doc, an, "FT");
    ObjPtr v = field_inherited(doc, an, "V");
    // /Ch (choice) fields present their selection like text; a
    // multi-select /V array shows its first entry (viewer convention)
    if (v->is(ObjType::Array) && !v->arr.empty()) v = doc->resolve(v->arr[0]);
    bool value_ink = false;
    if (ft->is(ObjType::Name) && (ft->s == "Tx" || ft->s == "Ch") &&
        v->is(ObjType::String) && !v->s.empty()) {
      std::string da, fname, colorops;
      double fsize = 0;
      ObjPtr dao = field_inherited(doc, an, "DA");
      if (!dao->is(ObjType::String)) {  // AcroForm-level default /DA
        ObjPtr root = doc->dict_get(doc->trailer(), "Root");
        dao = doc->dict_get(doc->dict_get(root, "AcroForm"), "DA");
      }
      if (dao->is(ObjType::String))
        syn_parse_da(dao->s, &fname, &fsize, &colorops);
      double rh = ry1 - ry0;
      if (fsize <= 0)  // "0 Tf" auto-size: fit the field height
        fsize = std::min(12.0, std::max(4.0, rh * 0.66));
      if (colorops.empty()) colorops = "0 g\n";
      std::string text = syn_text_decode(v->s);
      for (char& c : text)  // single-line presentation like viewers
        if (c == '\r' || c == '\n') c = ' ';
      ObjPtr fdict = syn_resolve_da_font(doc, fname);
      auto pf = load_font(doc, fdict);
      int q = 0;
      ObjPtr qo = field_inherited(doc, an, "Q");
      if (qo->is(ObjType::Int) || qo->is(ObjType::Real)) q = (int)qo->num();
      double tpad = 2 + bw;
      double lwid = syn_text_width(pf.get(), text, fsize);
      double x = rx0 + tpad;
      if (q == 1) x = rx0 + (rx1 - rx0 - lwid) / 2;
      else if (q == 2) x = rx1 - tpad - lwid;
      s += "BT\n/SynF ";
      syn_num(&s, fsize);
      s += "Tf\n" + colorops + "1 0 0 1 ";
      syn_num(&s, x);
      syn_num(&s, (ry0 + ry1) / 2 - fsize * 0.36);
      s += "Tm\n(";
      syn_escape(&s, text);
      s += ") Tj\nET\n";
      auto fres = std::make_shared<Object>();
      fres->type = ObjType::Dict;
      fres->dict["SynF"] = fdict;
      syn_ensure_res(res_out)->dict["Font"] = fres;
      value_ink = true;
    } else if (ft->is(ObjType::Name) && ft->s == "Btn" &&
               v->is(ObjType::Name) && v->s != "Off" &&
               // radio groups: /V lives on the parent field while each kid
               // widget carries its own /AS on-state — only the kid whose
               // /AS names the selected state gets ink (MuPDF's
               // pdf_appearance.c keys on/off per widget the same way).
               // A widget without /AS (plain checkbox) keeps /V semantics.
               (!doc->dict_get(an, "AS")->is(ObjType::Name) ||
                doc->dict_get(an, "AS")->s == v->s)) {
      // checked box / selected radio: a check-mark stroke
      double rw = rx1 - rx0, rh = ry1 - ry0;
      if (rw < 3 || rh < 3) return false;
      s += "0 G\n";
      syn_num(&s, std::max(1.0, std::min(rw, rh) * 0.12));
      s += "w\n";
      syn_num(&s, rx0 + rw * 0.22); syn_num(&s, ry0 + rh * 0.52);
      s += "m\n";
      syn_num(&s, rx0 + rw * 0.44); syn_num(&s, ry0 + rh * 0.26);
      s += "l\n";
      syn_num(&s, rx0 + rw * 0.78); syn_num(&s, ry0 + rh * 0.74);
      s += "l\nS\n";
      value_ink = true;
    } else if (ft->is(ObjType::Name) && ft->s == "Sig" &&
               v->is(ObjType::Dict)) {
      // signed signature field without /AP: viewers regenerate a
      // placeholder appearance from the signature dict (MuPDF
      // pdf_appearance.c draws the signer /Name plus details); render
      // the /Name (or "Signed") shrink-to-fit so a signed field is
      // visibly inked rather than blank. Unsigned fields (/V absent)
      // correctly stay at MK decoration only.
      std::string text = "Signed";
      ObjPtr nm = doc->dict_get(v, "Name");
      if (nm->is(ObjType::String) && !nm->s.empty())
        text = syn_text_decode(nm->s);
      for (char& c : text)
        if (c == '\r' || c == '\n') c = ' ';
      double rw = rx1 - rx0, rh = ry1 - ry0;
      if (rw >= 4 && rh >= 4) {
        ObjPtr fdict = syn_resolve_da_font(doc, "");
        auto pf = load_font(doc, fdict);
        double fsize = std::min(12.0, std::max(4.0, rh * 0.55));
        double lwid = syn_text_width(pf.get(), text, fsize);
        double avail = rw - 4;
        if (lwid > avail && lwid > 0) {  // shrink-to-fit like viewers
          fsize = std::max(4.0, fsize * avail / lwid);
          lwid = syn_text_width(pf.get(), text, fsize);
        }
        s += "BT\n/SynF ";
        syn_num(&s, fsize);
        s += "Tf\n0 g\n1 0 0 1 ";
        syn_num(&s, rx0 + std::max(2.0, (rw - lwid) / 2));
        syn_num(&s, (ry0 + ry1) / 2 - fsize * 0.36);
        s += "Tm\n(";
        syn_escape(&s, text);
        s += ") Tj\nET\n";
        auto fres = std::make_shared<Object>();
        fres->type = ObjType::Dict;
        fres->dict["SynF"] = fdict;
        syn_ensure_res(res_out)->dict["Font"] = fres;
        value_ink = true;
      }
    }
    if (!bg && !bc && !value_ink) return false;
  } else {
    return false;
  }
  *content += s;
  return true;
}

}  // namespace

bool ContentEngine::run(int page_index, PageContent* out, DisplayList* dl) {
  ObjPtr pg = doc_->page(page_index);
  if (!pg->is(ObjType::Dict)) return false;
  double bx0, by0, pw, ph;  // unrotated effective box (CropBox ∩ MediaBox)
  doc_->page_box(page_index, &bx0, &by0, &pw, &ph);
  int rot = doc_->page_rotation(page_index);
  double w, h;    // display size (rotated)
  doc_->page_size(page_index, &w, &h);
  dl->page_w = w;
  dl->page_h = h;

  Interp in;
  in.doc = doc_;
  in.out = out;
  in.dl = dl;
  // optional content: collect the OCGs the catalog's default viewing
  // configuration turns OFF (fitz honors these too)
  {
    ObjPtr root = doc_->dict_get(doc_->trailer(), "Root");
    ObjPtr ocp = doc_->dict_get(root, "OCProperties");
    ObjPtr dcfg = doc_->dict_get(ocp, "D");
    ObjPtr off = doc_->dict_get(dcfg, "OFF");
    if (off->is(ObjType::Array))
      for (auto& g : off->arr)
        in.hidden_ocgs.insert(doc_->resolve(g).get());
  }
  // device space: top-left origin, y down, units = points. /Rotate is
  // the display rotation (clockwise); folding it into the base CTM
  // rotates EVERYTHING downstream consistently — text/drawing/image
  // metadata, the display list, clips, and the raster (like fitz).
  switch (rot) {
    case 90:  in.gs.ctm = Matrix{0, 1, 1, 0, 0, 0}; break;
    case 180: in.gs.ctm = Matrix{-1, 0, 0, 1, pw, 0}; break;
    case 270: in.gs.ctm = Matrix{0, -1, -1, 0, ph, pw}; break;
    default:  in.gs.ctm = Matrix{1, 0, 0, -1, 0, ph}; break;
  }
  // shift by the effective box origin (CropBox ∩ MediaBox min corner),
  // same normalization page_box applies to the extent
  if (bx0 != 0 || by0 != 0) {
    Matrix shift{1, 0, 0, 1, -bx0, -by0};
    in.gs.ctm = shift.mul(in.gs.ctm);
  }
  in.gs.clip = Rect{0, 0, w, h};
  in.base_ctm = in.gs.ctm;  // pattern matrices map into page default space

  ObjPtr resources = doc_->page_inherited(pg, "Resources");
  ObjPtr contents = doc_->dict_get(pg, "Contents");
  std::string all;
  if (contents->is(ObjType::Stream)) {
    all = doc_->decode_stream(contents);
  } else if (contents->is(ObjType::Array)) {
    for (auto& c : contents->arr) {
      ObjPtr s = doc_->resolve(c);
      if (s->is(ObjType::Stream)) {
        all += doc_->decode_stream(s);
        all += "\n";
      }
    }
  }
  in.run_stream(all, resources);
  in.flush_span();

  // --- annotations: paint /AP /N appearance streams (PDF 32000-1 12.5.5).
  // fitz renders annotations by default in get_pixmap (the reference's
  // render path, pdf_image_segmentation.py:3651 uses the default), so
  // stamps / FreeText / widget appearances are part of the page pixels a
  // parity build must produce. Annotations WITHOUT an /AP get a
  // synthesized appearance (synth_annot_appearance above) for the
  // geometry/markup/FreeText/Stamp subtypes and all Widget field types
  // (text, choice, checkbox/radio, signature).
  ObjPtr annots = doc_->dict_get(pg, "Annots");
  if (annots->is(ObjType::Array)) {
    for (auto& aref : annots->arr) {
      ObjPtr an = doc_->resolve(aref);
      if (!an->is(ObjType::Dict)) continue;
      ObjPtr sub = doc_->dict_get(an, "Subtype");
      // links and popups are navigation chrome, never page ink (MuPDF
      // skips them in fz_run_page_annots too)
      if (sub->is(ObjType::Name) && (sub->s == "Link" || sub->s == "Popup"))
        continue;
      ObjPtr fo = doc_->dict_get(an, "F");
      int flags =
          (fo->is(ObjType::Int) || fo->is(ObjType::Real)) ? (int)fo->num() : 0;
      if (flags & 2) continue;   // Hidden
      if (flags & 32) continue;  // NoView
      ObjPtr aoc = doc_->dict_get(an, "OC");
      if (!aoc->is(ObjType::Null) && in.ocg_hidden(aoc)) continue;
      ObjPtr n = doc_->dict_get(doc_->dict_get(an, "AP"), "N");
      if (n->is(ObjType::Dict)) {  // appearance substates: select by /AS
        ObjPtr as = doc_->dict_get(an, "AS");
        ObjPtr pick = make_null();
        if (as->is(ObjType::Name)) {
          auto it = n->dict.find(as->s);
          if (it != n->dict.end()) pick = doc_->resolve(it->second);
        } else if (n->dict.size() == 1) {
          pick = doc_->resolve(n->dict.begin()->second);
        }
        n = pick;
      }
      ObjPtr ro = doc_->dict_get(an, "Rect");
      if (!ro->is(ObjType::Array) || ro->arr.size() != 4) continue;
      double rx0 = doc_->resolve(ro->arr[0])->num();
      double ry0 = doc_->resolve(ro->arr[1])->num();
      double rx1 = doc_->resolve(ro->arr[2])->num();
      double ry1 = doc_->resolve(ro->arr[3])->num();
      if (rx1 < rx0) std::swap(rx0, rx1);
      if (ry1 < ry0) std::swap(ry0, ry1);
      if (!n->is(ObjType::Stream)) {
        // no /AP: synthesize the standard subtypes' appearance from the
        // annotation dictionary like MuPDF's pdf_appearance.c; content
        // is emitted in page space, so only the base CTM applies
        std::string syn;
        ObjPtr synres = make_null();
        double pad = 0;
        if (!sub->is(ObjType::Name) ||
            !synth_annot_appearance(doc_, an, sub->s, rx0, ry0, rx1, ry1,
                                    &syn, &synres, &pad))
          continue;
        Interp ai;
        ai.doc = doc_;
        ai.out = out;
        ai.dl = dl;
        ai.hidden_ocgs = in.hidden_ocgs;
        ai.base_ctm = in.base_ctm;
        ai.gs.ctm = in.base_ctm;
        Rect bclip;  // /Rect grown by the stroke slop, in device space
        double cs[4][2] = {{rx0 - pad, ry0 - pad}, {rx1 + pad, ry0 - pad},
                           {rx1 + pad, ry1 + pad}, {rx0 - pad, ry1 + pad}};
        for (auto& c : cs) {
          double ox, oy;
          ai.gs.ctm.apply(c[0], c[1], &ox, &oy);
          bclip.grow(ox, oy);
        }
        ai.gs.clip.x0 = std::max(0.0, bclip.x0);
        ai.gs.clip.y0 = std::max(0.0, bclip.y0);
        ai.gs.clip.x1 = std::min(w, bclip.x1);
        ai.gs.clip.y1 = std::min(h, bclip.y1);
        if (ai.gs.clip.x1 <= ai.gs.clip.x0 ||
            ai.gs.clip.y1 <= ai.gs.clip.y0)
          continue;
        ai.run_stream(syn, synres);
        ai.flush_span();
        continue;
      }
      ObjPtr bo = doc_->dict_get(n, "BBox");
      if (!bo->is(ObjType::Array) || bo->arr.size() != 4) continue;
      double bx[4], by[4];
      {
        double v[4];
        for (int k = 0; k < 4; k++) v[k] = doc_->resolve(bo->arr[k])->num();
        bx[0] = v[0]; by[0] = v[1];
        bx[1] = v[2]; by[1] = v[1];
        bx[2] = v[2]; by[2] = v[3];
        bx[3] = v[0]; by[3] = v[3];
      }
      Matrix fm;  // form /Matrix, default identity
      ObjPtr mo = doc_->dict_get(n, "Matrix");
      if (mo->is(ObjType::Array) && mo->arr.size() == 6)
        fm = Matrix{doc_->resolve(mo->arr[0])->num(),
                    doc_->resolve(mo->arr[1])->num(),
                    doc_->resolve(mo->arr[2])->num(),
                    doc_->resolve(mo->arr[3])->num(),
                    doc_->resolve(mo->arr[4])->num(),
                    doc_->resolve(mo->arr[5])->num()};
      // 12.5.5 algorithm: bbox corners through /Matrix -> transformed
      // appearance box; A maps that box onto /Rect.
      double tx0 = 1e300, ty0 = 1e300, tx1 = -1e300, ty1 = -1e300;
      for (int k = 0; k < 4; k++) {
        double ox, oy;
        fm.apply(bx[k], by[k], &ox, &oy);
        tx0 = std::min(tx0, ox); ty0 = std::min(ty0, oy);
        tx1 = std::max(tx1, ox); ty1 = std::max(ty1, oy);
      }
      if (!(tx1 > tx0) || !(ty1 > ty0)) continue;  // degenerate bbox
      double sx = (rx1 - rx0) / (tx1 - tx0);
      double sy = (ry1 - ry0) / (ty1 - ty0);
      Matrix A{sx, 0, 0, sy, rx0 - tx0 * sx, ry0 - ty0 * sy};
      // fresh interpreter per annotation: content-stream state (text,
      // marked content, clips, gstack) must not leak page -> annot or
      // annot -> annot. Shares extraction sinks and OCG config.
      Interp ai;
      ai.doc = doc_;
      ai.out = out;
      ai.dl = dl;
      ai.hidden_ocgs = in.hidden_ocgs;
      ai.base_ctm = in.base_ctm;
      ai.gs.ctm = fm.mul(A).mul(in.base_ctm);
      // the form's /BBox clips its content (PDF 8.10.1); in device space
      // that is the transformed-corner extent intersected with the page
      Rect bclip;
      for (int k = 0; k < 4; k++) {
        double ox, oy;
        ai.gs.ctm.apply(bx[k], by[k], &ox, &oy);
        bclip.grow(ox, oy);
      }
      ai.gs.clip.x0 = std::max(0.0, bclip.x0);
      ai.gs.clip.y0 = std::max(0.0, bclip.y0);
      ai.gs.clip.x1 = std::min(w, bclip.x1);
      ai.gs.clip.y1 = std::min(h, bclip.y1);
      if (ai.gs.clip.x1 <= ai.gs.clip.x0 || ai.gs.clip.y1 <= ai.gs.clip.y0)
        continue;  // entirely off-page
      ObjPtr res2 = doc_->dict_get(n, "Resources");
      if (!res2->is(ObjType::Dict)) res2 = resources;
      ai.run_stream(doc_->decode_stream(n), res2);
      ai.flush_span();
    }
  }
  // one-time per-primitive paint bounds so region renders (the pipeline
  // renders each detected region twice at different DPIs) replay only
  // the content that can touch their clip (raster.cc culling)
  compute_display_bounds(dl);
  return true;
}

// ---------------------------------------------------------------------------
// image decode (embedded XObject -> RGB8)
// ---------------------------------------------------------------------------

std::vector<uint8_t> decode_image_rgb(Document* doc, int obj_num, int* w,
                                      int* h) {
  return decode_image_rgb_obj(doc, doc->get_object(obj_num), w, h);
}

std::vector<uint8_t> decode_image_alpha(Document* doc, const ObjPtr& xo,
                                        int* aw, int* ah) {
  *aw = *ah = 0;
  if (!xo->is(ObjType::Stream)) return {};
  ObjPtr im = doc->dict_get(xo, "ImageMask");
  if (im->is(ObjType::Bool) && im->b) {
    // stencil: 1-bit samples; Decode [0 1] (default) paints sample 0
    int w = (int)doc->dict_get(xo, "Width")->num();
    int h = (int)doc->dict_get(xo, "Height")->num();
    if (w <= 0 || h <= 0 || (int64_t)w * h > (int64_t)64 << 20) return {};
    bool invert = false;  // Decode [1 0]: paint sample 1
    ObjPtr dec = doc->dict_get(xo, "Decode");
    if (dec->is(ObjType::Array) && dec->arr.size() >= 1 &&
        doc->resolve(dec->arr[0])->num() == 1)
      invert = true;
    std::string data = doc->decode_stream(xo);
    size_t rowbytes = ((size_t)w + 7) / 8;
    std::vector<uint8_t> alpha((size_t)w * h, 0);
    for (int y = 0; y < h; y++) {
      for (int x = 0; x < w; x++) {
        size_t idx = (size_t)y * rowbytes + (size_t)x / 8;
        int bit = idx < data.size()
                      ? (((uint8_t)data[idx] >> (7 - x % 8)) & 1)
                      : 1;
        alpha[(size_t)y * w + x] = (bit == (invert ? 1 : 0)) ? 255 : 0;
      }
    }
    *aw = w;
    *ah = h;
    return alpha;
  }
  ObjPtr sm = doc->dict_get(xo, "SMask");
  if (sm->is(ObjType::Stream)) {
    std::vector<uint8_t> rgb = decode_image_rgb_obj(doc, sm, aw, ah);
    if (rgb.empty()) {
      *aw = *ah = 0;
      return {};
    }
    std::vector<uint8_t> alpha((size_t)(*aw) * (*ah));
    for (size_t i = 0; i < alpha.size(); i++) alpha[i] = rgb[i * 3];
    return alpha;
  }
  return {};
}

std::vector<uint8_t> decode_image_rgb_obj(Document* doc, const ObjPtr& xo,
                                          int* w, int* h) {
  if (!xo->is(ObjType::Stream)) return {};
  *w = (int)doc->dict_get(xo, "Width")->num();
  *h = (int)doc->dict_get(xo, "Height")->num();
  if (*w <= 0 || *h <= 0 || (int64_t)(*w) * (*h) > (int64_t)64 << 20)
    return {};
  int bpc = (int)doc->dict_get(xo, "BitsPerComponent")->num();
  if (bpc == 0) bpc = 8;
  ObjPtr cs = doc->dict_get(xo, "ColorSpace");
  ObjPtr filter = doc->dict_get(xo, "Filter");
  std::string fname = filter->is(ObjType::Array) && !filter->arr.empty()
                          ? doc->resolve(filter->arr.back())->s
                          : filter->s;
  if (fname == "JBIG2Decode") {
    // MMR/arithmetic/Huffman generic regions, symbol-dictionary/text
    // regions (incl. refinement coding), page refinement segments and
    // halftone regions decode for real (jbig2.cc — validated against
    // PIL's G4 encoder + a first-party spec encoder); only exotic
    // never-emitted forms fall back to the neutral plate.
    std::string globals;
    ObjPtr parms = doc->dict_get(xo, "DecodeParms");
    if (parms->is(ObjType::Array) && !parms->arr.empty())
      parms = doc->resolve(parms->arr.back());
    if (parms->is(ObjType::Dict)) {
      ObjPtr g = doc->dict_get(parms, "JBIG2Globals");
      if (g->is(ObjType::Stream)) globals = doc->decode_stream(g);
    }
    int jw = 0, jh = 0;
    // decode_stream applies decryption + any pre-filters and leaves the
    // JBIG2 payload itself untouched (unknown filters stay raw)
    std::vector<uint8_t> gray =
        jbig2_decode_gray(doc->decode_stream(xo), globals, &jw, &jh);
    if (!gray.empty() && jw > 0 && jh > 0) {
      *w = jw;
      *h = jh;
      std::vector<uint8_t> rgb((size_t)jw * jh * 3);
      for (size_t i = 0; i < gray.size(); i++)
        rgb[i * 3] = rgb[i * 3 + 1] = rgb[i * 3 + 2] = gray[i];
      return rgb;
    }
    return std::vector<uint8_t>((size_t)(*w) * (*h) * 3, 200);
  }
  if (fname == "JPXDecode") {
    // JPEG2000 decodes through the host callback, if one is registered
    // (spdf_set_jpx_decoder). The payload reaches it with pre-filters and
    // decryption applied. Without a decoder, or on a corrupt codestream,
    // the decode fails like any other: the caller sees no pixels.
    if (g_jpx_decode_cb) {
      std::string data = doc->decode_stream(xo);
      std::vector<uint8_t> rgb((size_t)(*w) * (*h) * 3);
      if (g_jpx_decode_cb((const uint8_t*)data.data(), (long)data.size(),
                          rgb.data(), *w, *h))
        return rgb;
    }
    return {};
  }
  if (fname == "DCTDecode" || fname == "DCT") {
    // run non-DCT pre-filters via decode_stream (it skips DCT), then jpeg
    std::string data = doc->decode_stream(xo);
    std::vector<uint8_t> rgb =
        dct_decode_rgb((const uint8_t*)data.data(), data.size(), w, h);
    return rgb;
  }
  std::string data = doc->decode_stream(xo);
  // color space analysis
  int ncomp = 1;
  std::string csname = cs->s;
  std::vector<uint8_t> palette;  // indexed
  int pal_ncomp = 3;
  if (cs->is(ObjType::Array) && !cs->arr.empty()) {
    ObjPtr c0 = doc->resolve(cs->arr[0]);
    csname = c0->s;
    if (csname == "I") csname = "Indexed";
    if (csname == "Indexed" && cs->arr.size() >= 4) {
      ObjPtr basecs = doc->resolve(cs->arr[1]);
      std::string basename = basecs->s;
      if (basecs->is(ObjType::Array) && !basecs->arr.empty())
        basename = doc->resolve(basecs->arr[0])->s;
      pal_ncomp = (basename == "DeviceCMYK" || basename == "CMYK") ? 4
                  : (basename == "DeviceGray" || basename == "CalGray" ||
                     basename == "G")
                      ? 1
                      : 3;
      ObjPtr lookup = doc->resolve(cs->arr[3]);
      if (lookup->is(ObjType::Stream)) {
        std::string lu = doc->decode_stream(lookup);
        palette.assign(lu.begin(), lu.end());
      } else if (lookup->is(ObjType::String)) {
        palette.assign(lookup->s.begin(), lookup->s.end());
      }
    } else if (csname == "ICCBased" && cs->arr.size() >= 2) {
      ObjPtr prof = doc->resolve(cs->arr[1]);
      ncomp = (int)doc->dict_get(prof, "N")->num();
      csname = ncomp == 1 ? "DeviceGray" : (ncomp == 4 ? "DeviceCMYK" : "DeviceRGB");
    }
  }
  // abbreviated names appear in inline images (PDF 8.9.7)
  if (csname == "DeviceRGB" || csname == "CalRGB" || csname == "RGB")
    ncomp = 3;
  else if (csname == "DeviceCMYK" || csname == "CMYK") ncomp = 4;
  else if (csname == "DeviceGray" || csname == "CalGray" || csname == "G")
    ncomp = 1;
  else if (csname == "Indexed" || csname == "I") {
    csname = "Indexed";
    ncomp = 1;
  }

  // /Decode array: per-component linear remap of samples (e.g. the
  // common [1 0] inversion on fax-scanned grayscale images)
  double dec_lo[4] = {0, 0, 0, 0}, dec_hi[4] = {1, 1, 1, 1};
  bool have_decode = false;
  {
    ObjPtr dec = doc->dict_get(xo, "Decode");
    if (dec->is(ObjType::Array) && (int)dec->arr.size() >= 2 * ncomp &&
        csname != "Indexed") {
      have_decode = true;
      for (int k = 0; k < ncomp && k < 4; k++) {
        dec_lo[k] = doc->resolve(dec->arr[2 * k])->num();
        dec_hi[k] = doc->resolve(dec->arr[2 * k + 1])->num();
      }
    }
  }
  auto remap = [&](int v, int comp) -> int {
    if (!have_decode) return v;
    double t = dec_lo[comp] + (v / 255.0) * (dec_hi[comp] - dec_lo[comp]);
    return (int)std::min(255.0, std::max(0.0, t * 255.0));
  };
  std::vector<uint8_t> out((size_t)(*w) * (*h) * 3, 255);
  size_t rowbytes = ((size_t)(*w) * ncomp * bpc + 7) / 8;
  auto sample = [&](size_t row, int x, int comp) -> int {
    size_t bitpos = (size_t)x * ncomp * bpc + (size_t)comp * bpc;
    size_t idx = row * rowbytes + bitpos / 8;
    if (idx >= data.size()) return 0;
    if (bpc == 8) return (uint8_t)data[idx];
    if (bpc == 1) return (((uint8_t)data[idx] >> (7 - bitpos % 8)) & 1) * 255;
    if (bpc == 4) {
      uint8_t v = (bitpos % 8 == 0) ? ((uint8_t)data[idx] >> 4)
                                    : ((uint8_t)data[idx] & 0xF);
      return v * 17;
    }
    if (bpc == 16) return (uint8_t)data[idx];
    return 0;
  };
  for (int y = 0; y < *h; y++) {
    for (int x = 0; x < *w; x++) {
      uint8_t* px = out.data() + ((size_t)y * (*w) + x) * 3;
      if (csname == "Indexed") {
        int rawidx;
        size_t bitpos = (size_t)x * bpc;
        size_t idx = (size_t)y * rowbytes + bitpos / 8;
        if (idx >= data.size()) continue;
        if (bpc == 8) rawidx = (uint8_t)data[idx];
        else if (bpc == 4)
          rawidx = (bitpos % 8 == 0) ? ((uint8_t)data[idx] >> 4)
                                     : ((uint8_t)data[idx] & 0xF);
        else if (bpc == 1)
          rawidx = ((uint8_t)data[idx] >> (7 - bitpos % 8)) & 1;
        else if (bpc == 2)
          rawidx = ((uint8_t)data[idx] >> (6 - (bitpos % 8))) & 3;
        else rawidx = 0;
        for (int k = 0; k < 3; k++) {
          size_t pi = (size_t)rawidx * pal_ncomp + (pal_ncomp == 1 ? 0 : k);
          px[k] = pi < palette.size() ? palette[pi] : 0;
        }
      } else if (ncomp == 1) {
        int v = remap(sample(y, x, 0), 0);
        px[0] = px[1] = px[2] = (uint8_t)v;
      } else if (ncomp == 3) {
        px[0] = (uint8_t)remap(sample(y, x, 0), 0);
        px[1] = (uint8_t)remap(sample(y, x, 1), 1);
        px[2] = (uint8_t)remap(sample(y, x, 2), 2);
      } else if (ncomp == 4) {
        int cc = remap(sample(y, x, 0), 0), m = remap(sample(y, x, 1), 1),
            yy = remap(sample(y, x, 2), 2), k = remap(sample(y, x, 3), 3);
        px[0] = (uint8_t)((255 - cc) * (255 - k) / 255);
        px[1] = (uint8_t)((255 - m) * (255 - k) / 255);
        px[2] = (uint8_t)((255 - yy) * (255 - k) / 255);
      }
    }
  }
  return out;
}

}  // namespace spdf
