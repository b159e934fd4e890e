"""Corrupt-input robustness for the native PDF engine.

The engine's whole job is ingesting third-party PDFs, and real-world
files are routinely damaged (truncated downloads, bad OCR re-saves,
broken incremental writers). The reference gets this robustness from
MuPDF (ref pdf_image_segmentation.py:2731), which survives arbitrary
corruption; this suite locks in the same property for spdf.

A seeded corpus of mutated PDFs (byte flips, truncations, chunk
deletes/duplicates, stream zeroing) over structurally diverse bases
(TrueType book, CFF, Type1, RC4/AES encrypted) must never crash or
hang the process — every case either parses (possibly to an empty
document) or raises a clean Python exception. Cases run in ONE child
interpreter so a segfault/deadlock fails THIS test instead of killing
the pytest process.

Fuzz findings this suite regression-tests (all fixed in native/src):
- font.cc parse_glyph_outline: unvalidated loca offsets read far out
  of the glyf table; unchecked instruction-count skip; non-monotonic
  contour ends overflowing the point arrays; unchecked composite
  scale reads.
- content.cc parse_tounicode: a stray delimiter in a corrupt CMap made
  next_keyword() return empty without consuming -> infinite loop.
"""
from __future__ import annotations

import os
import random
import subprocess
import sys

import pytest

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS_DIR)

_WORKER = r"""
import sys
from synapta_tpu.io.ingest import open_pdf
bad = 0
for path in sys.argv[1:]:
    try:
        d = open_pdf(path)
        for p in range(min(d.page_count, 2)):
            d.render(p, dpi=40)
            d.page_text_blocks(p)
            for im in d.page_images(p):
                try:
                    d.decode_image(im.get("obj", 0))
                except Exception:
                    pass
    except Exception:
        pass  # clean refusal is a correct outcome for corrupt input
print("FUZZDONE")
"""


def _rich_base() -> bytes:
    """One page exercising every round-3 renderer feature: tiling
    pattern, Type-4 calculator shading, dash, inline image + stencil,
    SMask'd image, Separation scn, /Rotate, /BM blend modes and an
    ExtGState /SMask luminosity group — corrupting THIS base fuzzes the
    newest code paths."""
    import zlib

    from tests.fontfixtures import _pdf

    rgbpx = zlib.compress(bytes([0, 200, 0] * 16))
    red = bytes([255, 0, 0] * 64)
    ramp = bytes([min(255, x * 36) for _ in range(8) for x in range(8)])

    def obj_stream(dct: bytes, payload: bytes) -> bytes:
        z = zlib.compress(payload)
        return (dct + b" /Filter /FlateDecode /Length " +
                str(len(z)).encode() + b" >>\nstream\n" + z +
                b"\nendstream")

    import struct

    prog = b"{ dup 1 exch sub exch 0 exch }"
    cell = b"1 0 0 rg 0 0 4 10 re f"

    def vert(flag, x, y, r, g, b):
        return (bytes([flag]) +
                struct.pack(">HH", int(x / 612 * 65535),
                            int(y / 792 * 65535)) + bytes([r, g, b]))

    mesh = (vert(0, 60, 60, 255, 0, 0) + vert(0, 200, 60, 0, 255, 0) +
            vert(0, 130, 200, 0, 0, 255))
    content = (
        b"/Pattern cs /P0 scn 50 500 200 100 re f /S0 sh /S1 sh "
        b"2 w [6 4] 1 d 0 0 0 RG 50 450 m 550 450 l S "
        b"q 100 0 0 100 50 600 cm BI /W 4 /H 4 /CS /RGB /BPC 8 /F /Fl "
        b"/L " + str(len(rgbpx)).encode() + b" ID " + rgbpx + b" EI Q "
        b"q 100 0 0 100 300 600 cm /Im1 Do Q "
        b"/CS1 cs 0.8 scn 400 450 100 50 re f "
        b"0.9 0.1 0.1 rg 100 300 200 100 re f "
        b"/GS1 gs 0.1 0.2 0.9 rg 200 250 200 100 re f "
        b"/GS2 gs 0 0 0 rg 350 300 150 100 re f")
    return _pdf([
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 612 792] "
        b"/Rotate 90 /Contents 4 0 R /Resources << "
        b"/Pattern << /P0 5 0 R >> "
        b"/Shading << /S0 6 0 R /S1 10 0 R >> "
        b"/XObject << /Im1 8 0 R >> "
        b"/ExtGState << /GS1 << /BM /Multiply /ca 0.7 >> "
        b"/GS2 << /BM /Luminosity /SMask << /S /Luminosity /G 11 0 R >> "
        b">> >> "
        b"/ColorSpace << /CS1 [/Separation /Sp /DeviceRGB 7 0 R] >> >> >>",
        b"<< /Length " + str(len(content)).encode() +
        b" >>\nstream\n" + content + b"\nendstream",
        b"<< /Type /Pattern /PatternType 1 /PaintType 1 /TilingType 1 "
        b"/BBox [0 0 10 10] /XStep 10 /YStep 10 /Resources << >> "
        b"/Length " + str(len(cell)).encode() + b" >>\nstream\n" +
        cell + b"\nendstream",
        b"<< /ShadingType 2 /ColorSpace /DeviceRGB /Coords [0 0 612 0] "
        b"/Function 7 0 R >>",
        b"<< /FunctionType 4 /Domain [0 1] /Range [0 1 0 1 0 1] "
        b"/Length " + str(len(prog)).encode() + b" >>\nstream\n" +
        prog + b"\nendstream",
        obj_stream(b"<< /Type /XObject /Subtype /Image /Width 8 /Height 8"
                   b" /ColorSpace /DeviceRGB /BitsPerComponent 8 "
                   b"/SMask 9 0 R", red),
        obj_stream(b"<< /Type /XObject /Subtype /Image /Width 8 /Height 8"
                   b" /ColorSpace /DeviceGray /BitsPerComponent 8", ramp),
        b"<< /ShadingType 4 /ColorSpace /DeviceRGB /BitsPerCoordinate 16"
        b" /BitsPerComponent 8 /BitsPerFlag 8 "
        b"/Decode [0 612 0 792 0 1 0 1 0 1] /Length " +
        str(len(mesh)).encode() + b" >>\nstream\n" + mesh +
        b"\nendstream",
        obj_stream(b"<< /Type /XObject /Subtype /Form "
                   b"/BBox [200 250 500 450] /Group "
                   b"<< /S /Transparency /CS /DeviceGray >> "
                   b"/Resources << /Shading << /S0 6 0 R >> >>",
                   b"q 200 250 300 200 re W n /S0 sh Q"),
    ])


def _mutants(data: bytes, rng: random.Random, out_dir: str, tag: str,
             n_flips: int = 14, n_struct: int = 10) -> list:
    """Seeded mutation classes over one base document."""
    n = len(data)
    paths = []

    def emit(buf: bytes) -> None:
        p = os.path.join(out_dir, f"{tag}_{len(paths):03d}.pdf")
        with open(p, "wb") as f:
            f.write(buf)
        paths.append(p)

    for _ in range(n_flips):  # byte flips, single to bursty
        mut = bytearray(data)
        for _ in range(rng.choice([1, 2, 8, 32, 128])):
            mut[rng.randrange(n)] = rng.randrange(256)
        emit(bytes(mut))
    for _ in range(n_struct):  # truncation
        emit(data[: rng.randrange(16, n)])
    for _ in range(n_struct):  # chunk delete
        a = rng.randrange(n)
        b = min(n, a + rng.randrange(1, 4096))
        emit(data[:a] + data[b:])
    for _ in range(n_struct):  # chunk duplicate at random offset
        a = rng.randrange(n)
        b = min(n, a + rng.randrange(1, 2048))
        c = rng.randrange(n)
        emit(data[:c] + data[a:b] + data[c:])
    for _ in range(n_struct):  # tail corruption (xref/trailer territory)
        mut = bytearray(data)
        for _ in range(rng.choice([1, 4, 16])):
            mut[n - 1 - rng.randrange(min(n, 3000))] = rng.randrange(256)
        emit(bytes(mut))
    for _ in range(6):  # zero a stream-sized region
        mut = bytearray(data)
        a = rng.randrange(n)
        b = min(n, a + rng.randrange(64, 8192))
        mut[a:b] = bytes(b - a)
        emit(bytes(mut))
    return paths


@pytest.mark.parametrize(
    "base",
    ["ttf_book", "cff", "type1", "enc", "pil_images", "ccitt", "rich",
     "jbig2", "jbig2_arith", "jbig2_huff", "jbig2_refine", "annots"],
)
def test_corrupt_pdfs_never_crash_or_hang(base, tmp_path):
    rng = random.Random(20260818)
    if base == "ttf_book":
        from synapta_tpu.io.pdf_writer import make_test_book

        src = str(tmp_path / "base.pdf")
        make_test_book(src, pages=2, seed=3)
        data = open(src, "rb").read()
    elif base == "cff":
        from tests.fontfixtures import make_cff_pdf

        data = make_cff_pdf(False)
    elif base == "type1":
        from tests.fontfixtures import make_type1_pdf

        data = make_type1_pdf()
    elif base == "enc":
        from tests.encfixtures import make_encrypted_pdf

        data = make_encrypted_pdf(aes=True)
    elif base == "pil_images":
        from tests.corpus import make_pil_book

        src = str(tmp_path / "pil.pdf")
        make_pil_book(src, pages=2)
        data = open(src, "rb").read()
    elif base == "ccitt":
        import numpy as np  # noqa: F401

        from tests.test_ccitt import _ccitt_pdf, _g4_strip, _textlike

        bm = _textlike(96, 160, 4)
        data = _ccitt_pdf(bm, _g4_strip(bm))
    elif base == "rich":
        data = _rich_base()
    elif base == "annots":  # /Annots appearance streams (12.5.5 fitting)
        from tests.test_annots import _annot_page, _form, _pdf

        forms = [
            _form(b"0 0 10 10", b"1 0 0 rg 0 0 10 10 re f\n"),
            _form(b"0 0 40 10", b"0 0 1 rg 0 0 40 10 re f\n",
                  matrix=b"0 1 -1 0 0 0"),
            _form(b"0 0 10 10", b""),
        ]
        annots = [
            (b"<< /Type /Annot /Subtype /Square /Rect [100 100 200 150] "
             b"/AP << /N 8 0 R >> >>"),
            (b"<< /Type /Annot /Subtype /Widget /Rect [30 30 60 60] "
             b"/AP << /N << /On 8 0 R /Off 10 0 R >> >> /AS /On >>"),
            (b"<< /Type /Annot /Subtype /Stamp /Rect [50 200 70 280] "
             b"/F 4 /AP << /N 9 0 R >> >>"),
            # AP-less: every synthesized subtype (content.cc
            # synth_annot_appearance) so mutations hit those paths too
            (b"<< /Type /Annot /Subtype /Circle /Rect [10 10 90 90] "
             b"/C [1 0 0] /IC [0 0 1] /BS << /W 3 >> /CA 0.6 >>"),
            (b"<< /Type /Annot /Subtype /Line /Rect [0 0 300 300] "
             b"/L [20 20 280 280] /C [0 1 0] >>"),
            (b"<< /Type /Annot /Subtype /Ink /Rect [0 0 300 300] "
             b"/InkList [[10 10 50 40 90 10] [100 100 200 120]] "
             b"/C [0.2 0.2 0.9] >>"),
            (b"<< /Type /Annot /Subtype /Highlight /Rect [20 200 280 260] "
             b"/C [1 1 0] /QuadPoints [20 260 280 260 20 200 280 200] >>"),
            (b"<< /Type /Annot /Subtype /Squiggly /Rect [20 150 280 180] "
             b"/C [1 0 0] /QuadPoints [20 180 280 180 20 150 280 150] >>"),
            (b"<< /Type /Annot /Subtype /Polygon /Rect [0 0 300 300] "
             b"/Vertices [150 250 250 150 50 150] /C [0 0 0] "
             b"/IC [0 1 0] >>"),
            # AP-less text-bearing subtypes: /DA parsing, word wrap,
            # substitute-font layout, camel-case stamp banner
            (b"<< /Type /Annot /Subtype /FreeText /Rect [50 180 250 260] "
             b"/C [1 1 0] /DA (0 0 1 rg /Helv 11 Tf) /Q 1 "
             b"/Contents (lorem ipsum dolor sit amet consectetur "
             b"adipiscing\\nelit sed do eiusmod) >>"),
            (b"<< /Type /Annot /Subtype /Stamp /Rect [60 100 240 160] "
             b"/Name /NotApproved >>"),
            (b"<< /Type /Annot /Subtype /Widget /FT /Tx /Rect "
             b"[50 50 250 80] /V (fuzzed value) /DA (0 g /Helv 0 Tf) "
             b"/MK << /BG [0.9] /BC [0] >> >>"),
            (b"<< /Type /Annot /Subtype /Widget /FT /Btn /Rect "
             b"[260 50 290 80] /V /Yes /MK << /BC [0] >> >>"),
            # round-4 synthesis surfaces: /AS-keyed radio, /Ch choice,
            # signed /Sig placeholder (indirect sig dict lands at 8 0 R
            # == forms[0]; mutations exercise the dict-type guards)
            (b"<< /Type /Annot /Subtype /Widget /FT /Btn /Rect "
             b"[260 90 290 120] /V /Opt2 /AS /Opt1 >>"),
            (b"<< /Type /Annot /Subtype /Widget /FT /Ch /Rect "
             b"[50 90 200 115] /V [(Equities) (Bonds)] "
             b"/DA (0 g /Helv 9 Tf) >>"),
            (b"<< /Type /Annot /Subtype /Widget /FT /Sig /Rect "
             b"[50 120 220 150] /V << /Type /Sig /Name (Fuzz Signer) >> "
             b">>"),
        ]
        data = _pdf(_annot_page(annots, extra_objs=forms,
                                contents=b"0.5 g 0 0 300 300 re f\n"))
    elif base == "jbig2":  # MMR generic-region segment stream
        from tests.test_ccitt import _jbig2_pdf, _textlike

        data = _jbig2_pdf(_textlike(96, 160, 11), mmr=True)
    elif base == "jbig2_arith":  # MQ generic region + symbol dict + text
        import numpy as np

        from tests.jbig2fixtures import (generic_region_segment,
                                         jbig2_pdf, page_info_segment,
                                         symbol_dict_segment,
                                         text_region_segment)
        from tests.test_ccitt import _textlike

        syms = [(np.random.default_rng(i).random((8, 6 + i)) > 0.5)
                .astype(np.uint8) for i in range(3)]
        seg_sd, order = symbol_dict_segment(syms, num=1, page=1)
        export = [syms[i] for i in order]
        seg_tr = text_region_segment(
            120, 60, [(i % 3, 8 + 20 * i, 30) for i in range(4)],
            export, num=2, refs=(1,), refcorner=1)
        stream = (page_info_segment(160, 96, num=0) + seg_sd + seg_tr +
                  generic_region_segment(_textlike(96, 160, 7), num=3,
                                         tpgdon=True))
        data = jbig2_pdf(stream, 160, 96)
    elif base == "jbig2_refine":
        # round-4 refinement/halftone surface: refagg symbol dict,
        # refined text-region instances, page refinement segment,
        # pattern dict + halftone region (gray bitplanes, skewed grid)
        import numpy as np

        from tests.jbig2fixtures import (halftone_region_segment,
                                         jbig2_pdf, page_info_segment,
                                         pattern_dict_segment,
                                         refinement_region_segment,
                                         symbol_dict_refagg_segment,
                                         symbol_dict_segment,
                                         text_region_segment)
        from tests.test_ccitt import _textlike

        syms = [(np.random.default_rng(i).random((8, 6 + i)) > 0.5)
                .astype(np.uint8) for i in range(3)]
        seg_sd, order = symbol_dict_segment(syms, num=1, page=1)
        base_syms = [syms[i] for i in order]
        enc = []
        for i, b in enumerate(base_syms):
            t = b.copy()
            t[0, 0] ^= 1
            enc.append((t, i, (i % 3) - 1, i % 2, b))
        seg_ref = symbol_dict_refagg_segment(enc, insym_shapes=3, num=2,
                                             page=1, refs=(1,))
        export = [e[0] for e in enc]
        ref0 = export[0]
        rbm = np.zeros((ref0.shape[0] + 2, ref0.shape[1] + 1), np.uint8)
        rbm[1:1 + ref0.shape[0], : ref0.shape[1]] = ref0
        seg_tr = text_region_segment(
            120, 60, [(0, 8, 30, rbm, 1, -1), (1, 40, 30), (2, 70, 30)],
            export, num=3, refs=(2,), sbrefine=True)
        basebm = _textlike(40, 60, 13).astype(np.uint8)
        tgt = basebm.copy()
        tgt[5:15, 5:25] ^= 1
        seg_gen = None
        from tests.jbig2fixtures import generic_region_segment

        seg_gen = generic_region_segment(basebm, num=4, x=0, y=36)
        seg_rr = refinement_region_segment(tgt, num=5, x=0, y=36,
                                           reference=basebm, tpgron=True)
        pats = [np.ones((4, 4), np.uint8) * (k % 2) for k in range(4)]
        seg_pd = pattern_dict_segment(pats, num=6, page=1)
        grid = np.arange(12, dtype=np.uint16).reshape(3, 4) % 4
        seg_ht = halftone_region_segment(grid, pats, 40, 20, num=7,
                                         refs=(6,), x=110, y=70,
                                         rx=4 * 256 + 32, ry=16)
        stream = (page_info_segment(160, 96, num=0) + seg_sd + seg_ref +
                  seg_tr + seg_gen + seg_rr + seg_pd + seg_ht)
        data = jbig2_pdf(stream, 160, 96)
    else:  # jbig2_huff: Huffman dict (custom DH table, MMR collective)
        # + Huffman text region — the round-4 decoder surface (bit
        # readers, canonical assignment, table segment parsing,
        # collective-bitmap splitting, run-coded symbol IDs)
        import numpy as np

        from tests.jbig2fixtures import (HuffEnc, custom_table_segment,
                                         huff_symbol_dict_segment,
                                         huff_text_region_segment,
                                         jbig2_pdf, page_info_segment)

        syms = [(np.random.default_rng(i).random((8, 6 + i)) > 0.5)
                .astype(np.uint8) for i in range(3)]
        seg_tab = custom_table_segment([(2, 2), (2, 2), (2, 2), (3, 2)],
                                       0, 16, num=8, page=0, htps=4,
                                       htrs=4, lower_len=4, upper_len=4)
        enc = HuffEnc([(2, 2, 0, 0), (2, 2, 4, 0), (2, 2, 8, 0),
                       (3, 2, 12, 0), (4, 32, -1, 1), (4, 32, 16, 0)])
        seg_sd, order = huff_symbol_dict_segment(
            syms, num=1, page=1, mmr=True, sel_dh=3, refs=(8,),
            custom_dh=enc)
        export = [syms[i] for i in order]
        seg_tr = huff_text_region_segment(
            120, 60, [(i % 3, 8 + 20 * i, 30) for i in range(4)],
            export, num=2, refs=(1,), refcorner=1)
        stream = page_info_segment(160, 96, num=0) + seg_tab + seg_sd + seg_tr
        data = jbig2_pdf(stream, 160, 96)

    out = tmp_path / "cases"
    out.mkdir()
    paths = _mutants(data, rng, str(out), base)

    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [p for p in (REPO, env.get("PYTHONPATH", "")) if p]
    )
    env["JAX_PLATFORMS"] = "cpu"
    # generous wall bound: the whole corpus runs in a few seconds when
    # healthy; a single infinite loop blows straight through this
    r = subprocess.run(
        [sys.executable, str(worker)] + paths,
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO,
    )
    assert r.returncode == 0, (
        f"engine crashed on a corrupt input (rc={r.returncode}); "
        f"stderr tail: {r.stderr[-400:]}"
    )
    assert "FUZZDONE" in r.stdout


def test_cascaded_flate_bomb_contained(tmp_path):
    """A crafted [/FlateDecode /FlateDecode] stream expanding a ~500-byte
    payload toward gigabytes must be contained by the per-stream decode
    ceiling (object.cc kMaxDecodedStream) instead of OOMing the host.
    The page still renders (blank) and peak RSS stays bounded.

    Runs in a child interpreter: ru_maxrss is process-lifetime peak, so
    measuring in the pytest process would assert on whatever earlier
    tests happened to allocate, not on the bomb guard."""
    import zlib

    from tests.fontfixtures import _pdf

    body = zlib.compress(zlib.compress(b"\0" * (1 << 28), 9), 9)
    pdf = _pdf([
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 612 792] "
        b"/Contents 4 0 R /Resources << >> >>",
        b"<< /Length " + str(len(body)).encode() +
        b" /Filter [/FlateDecode /FlateDecode] >>\nstream\n" +
        body + b"\nendstream",
    ])
    p = tmp_path / "bomb.pdf"
    p.write_bytes(pdf)
    probe = tmp_path / "bomb_probe.py"
    probe.write_text(
        "import os, resource, sys\n"
        "from synapta_tpu.io.ingest import open_pdf\n"
        "def rss():\n"
        "    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss/1024\n"
        "base_mb = rss()  # post-import baseline: interpreter + numpy +\n"
        "                 # engine .so, which vary with env/build, are not\n"
        "                 # what the bomb guard bounds\n"
        "d = open_pdf(sys.argv[1])\n"
        "arr = d.render(0, dpi=72)\n"
        "assert arr is not None and arr.shape == (792, 612, 3), arr\n"
        "delta_mb = rss() - base_mb\n"
        "# sanitizer builds (SPDF_NATIVE_SO override) carry shadow-memory\n"
        "# overhead; the tight bar is for the production engine\n"
        "bar = 2400 if os.environ.get('SPDF_NATIVE_SO') else 700\n"
        "assert delta_mb < bar, f'render RSS delta {delta_mb:.0f}MB'\n"
        "print('BOMBOK')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [p_ for p_ in (REPO, env.get("PYTHONPATH", "")) if p_]
    )
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, str(probe), str(p)],
        capture_output=True, text=True, timeout=240, env=env, cwd=REPO,
    )
    assert r.returncode == 0, (
        f"bomb guard failed (rc={r.returncode}); "
        f"stderr tail: {r.stderr[-400:]}"
    )
    assert "BOMBOK" in r.stdout
