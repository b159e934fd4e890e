"""Native PDF engine tests: parse/extract/decode/render vs the synthetic
book's ground truth."""
import numpy as np
import pytest

from synapta_tpu.io.ingest import open_pdf
from synapta_tpu.io.pdf_writer import make_test_book


@pytest.fixture(scope="module")
def book(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pdf") / "book.pdf")
    truths = make_test_book(path, pages=8, seed=3)
    return open_pdf(path), truths


def iou(a, b):
    ix = max(0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / ua if ua > 0 else 0.0


def test_page_count_and_size(book):
    doc, truths = book
    assert doc.page_count == len(truths) == 8
    assert doc.page_size(0) == (612.0, 792.0)


def test_text_spans_match_truth(book):
    doc, truths = book
    matched = total = 0
    for p in range(8):
        spans = doc.page_spans(p)
        for tb in truths[p].text_blocks:
            total += 1
            best = 0.0
            for s in spans:
                if s["text"].startswith(tb["text"][:20]) or tb["text"].startswith(
                    s["text"][:20]
                ):
                    best = max(best, iou(s["bbox"], tb["bbox"]))
            if best > 0.5:
                matched += 1
    assert matched / total > 0.95, f"only {matched}/{total} text spans matched"


def test_font_sizes_extracted(book):
    doc, _ = book
    sizes = {round(s["size"]) for s in doc.page_spans(0)}
    assert 15 in sizes  # chapter heading
    assert 10 in sizes  # body


def test_drawings_on_chart_page(book):
    doc, truths = book
    # page 1 = bar chart: grid lines + axes + bars
    d = doc.page_drawings(1)
    assert len(d) >= 8
    rects = [x for x in d if x["is_rect"] and x["kind"] in (1, 2)]
    assert len(rects) >= truths[1].visuals[0].extra["bars"]
    # drawings lie within the truth visual bbox (plus caption band)
    vb = truths[1].visuals[0].bbox
    for x in rects:
        assert iou(x["bbox"], vb) > 0 or (
            vb[0] - 5 <= x["bbox"][0] and x["bbox"][2] <= vb[2] + 5
        )


def test_embedded_image_decode_exact(book):
    doc, truths = book
    # page 4 = embedded photo (FlateDecode RGB -> decode must be exact)
    ims = doc.page_images(4)
    assert len(ims) == 1
    truth = truths[4].visuals[0]
    assert iou(ims[0]["bbox"], truth.bbox) > 0.98
    arr = doc.decode_image(ims[0]["obj"])
    assert arr is not None
    assert list(arr.shape) == truth.extra["shape"]


def test_render_region_consistent_with_page(book):
    doc, _ = book
    full = doc.render(1, dpi=72)
    region = doc.render(1, dpi=72, clip=[100, 200, 300, 400])
    sub = full[200:400, 100:300]
    # identical up to AA boundary effects at the crop edge
    diff = np.abs(sub.astype(int) - region.astype(int))
    assert (diff > 8).mean() < 0.02


def test_render_dpi_scaling(book):
    doc, _ = book
    a = doc.render(0, dpi=36)
    b = doc.render(0, dpi=72)
    assert b.shape[0] == 2 * a.shape[0] and b.shape[1] == 2 * a.shape[1]


def test_render_has_ink(book):
    doc, _ = book
    arr = doc.render(0, dpi=72)
    assert arr.mean() > 200  # mostly white page
    assert (arr < 128).any()  # but with dark text ink


def test_jpeg_book_decodes(tmp_path):
    path = str(tmp_path / "jpeg_book.pdf")
    truths = make_test_book(path, pages=5, seed=7, jpeg_images=True)
    doc = open_pdf(path)
    ims = doc.page_images(4)
    assert len(ims) == 1
    arr = doc.decode_image(ims[0]["obj"])
    assert arr is not None and arr.shape[2] == 3
    # JPEG is lossy; compare statistics only
    assert 20 < arr.mean() < 240


def test_text_blocks_grouping(book):
    doc, _ = book
    blocks = doc.page_text_blocks(0)
    # the wrapped paragraph should merge into one block of >200 chars
    assert any(len(b["text"]) > 200 for b in blocks)


def test_png_encode_roundtrip_palettized_and_truecolor():
    """Both PNG encoder paths (PNG8/Z_RLE and truecolor/level-1) must be
    lossless and spec-conformant (native/src/api.cc::spdf_png_encode)."""
    import io

    import numpy as np
    from PIL import Image

    from synapta_tpu.io.ingest import png_encode

    # palettized path: flat fills + few colors
    pal = np.full((120, 200, 3), 255, np.uint8)
    pal[10:50, 20:180] = (200, 30, 30)
    pal[60:100, 20:90] = (30, 80, 200)
    pal[55:58, :] = 0
    # truecolor path: smooth gradient -> > 256 distinct colors
    yy, xx = np.mgrid[0:120, 0:200]
    tru = np.stack(
        [(yy * 2) % 256, (xx * 3) % 256, (yy + xx) % 256], -1
    ).astype(np.uint8)
    for img in (pal, tru):
        data = png_encode(img)
        im = Image.open(io.BytesIO(data))
        im.load()
        back = np.asarray(im.convert("RGB"))
        assert np.array_equal(back, img)
    # palettized output actually uses the PNG8 path (color type 3)
    assert png_encode(pal)[25] == 3
    assert png_encode(tru)[25] == 2


def test_box_downscale_properties():
    """Native ink-preserving area downscale (ingest.box_downscale):
    uniform areas exact, dims honored, sub-pixel dark strokes stay below
    the ops/filters.binarize_ink threshold (the reason it exists)."""
    import numpy as np

    from synapta_tpu.io.ingest import box_downscale

    # uniform image stays exactly uniform at any ratio
    uni = np.full((311, 471, 3), 137, np.uint8)
    out = box_downscale(uni, 200, 313)
    assert out.shape == (200, 313, 3)
    assert np.all(out == 137)
    # a 1px black horizontal line at 1.5x downscale must stay ink-dark
    # (< 200 gray) and unbroken along its full length
    img = np.full((150, 300, 3), 255, np.uint8)
    img[75, :, :] = 0
    out = box_downscale(img, 100, 200)
    gray = out.astype(int).sum(-1) / 3.0
    line_rows = (gray < 200).any(axis=1)
    assert line_rows.any()
    row = gray[np.argmax((gray < 200).sum(axis=1))]
    assert (row < 200).all(), "stroke must not break into dashes"


def test_incremental_update_newest_revision_wins(tmp_path):
    """Incremental-update PDFs (appended revision + xref /Prev chain,
    PDF 32000-1 §7.5.6): the engine must resolve each object from the
    NEWEST revision. Real editors (Acrobat 'save', signing tools) append
    rather than rewrite, so a parser that reads only the first xref or
    prefers older entries silently shows stale content."""
    import io

    from fontfixtures import _pdf, _stream

    from synapta_tpu.io.ingest import open_pdf

    objs = [
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        (b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 612 792] "
         b"/Resources << /Font << /F1 5 0 R >> >> /Contents 4 0 R >>"),
        _stream(b"", b"BT /F1 24 Tf 72 700 Td (Hello original) Tj ET\n"),
        b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>",
    ]
    base = _pdf(objs)
    prev_xref = int(base.rsplit(b"startxref\n", 1)[1].split(b"\n", 1)[0])

    # append a revision replacing object 4 (the content stream)
    new4 = _stream(b"", b"BT /F1 24 Tf 72 700 Td (Hello updated) Tj ET\n")
    upd = io.BytesIO()
    upd.write(base)
    off4 = upd.tell()
    upd.write(b"4 0 obj\n" + new4 + b"\nendobj\n")
    xref = upd.tell()
    upd.write(b"xref\n0 1\n0000000000 65535 f \n")
    upd.write(b"4 1\n%010d 00000 n \n" % off4)
    upd.write(b"trailer\n<< /Size 6 /Root 1 0 R /Prev %d >>\n" % prev_xref)
    upd.write(b"startxref\n%d\n%%%%EOF\n" % xref)

    path = str(tmp_path / "incremental.pdf")
    with open(path, "wb") as f:
        f.write(upd.getvalue())
    doc = open_pdf(path)
    texts = [b["text"] for b in doc.page_text_blocks(0)]
    assert any("updated" in t for t in texts), texts
    assert not any("original" in t for t in texts), texts
    # the updated content must also be what rasterizes
    arr = doc.render(0, dpi=72)
    assert (arr < 128).any()


def test_mediabox_corner_normalization(tmp_path):
    """The spec allows MediaBox corners in any order and real generators
    emit inverted boxes; readers (incl. fitz, ref :2731) normalize.
    Inverted corners must render identically to the normal form, and
    non-finite boxes must fall back to US Letter instead of a 1x1 plate."""
    import numpy as np

    from tests.fontfixtures import _pdf

    def book(mb: bytes) -> bytes:
        return _pdf([
            b"<< /Type /Catalog /Pages 2 0 R >>",
            b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
            b"<< /Type /Page /Parent 2 0 R /MediaBox " + mb +
            b" /Contents 4 0 R /Resources << >> >>",
            b"<< /Length 40 >>\nstream\n0 0 m 100 100 l S\nendstream",
        ])

    renders = {}
    for name, mb in [("normal", b"[0 0 612 792]"),
                     ("inverted", b"[612 792 0 0]"),
                     ("nan", b"[0 0 nan nan]")]:
        p = tmp_path / f"{name}.pdf"
        p.write_bytes(book(mb))
        d = open_pdf(str(p))
        w, h = d.page_size(0)
        assert (w, h) == (612.0, 792.0), (name, w, h)
        renders[name] = np.asarray(d.render(0, dpi=72))
    assert renders["normal"].shape == renders["inverted"].shape
    assert (renders["normal"] == renders["inverted"]).all()


def test_page_rotate_renders_and_reports_display_space(tmp_path):
    """/Rotate (inheritable, clockwise display rotation) must rotate the
    raster, the page size, and all metadata coordinates consistently —
    fitz semantics. Solid-fill content is pixel-exact against
    numpy-rotating the unrotated render."""
    from tests.fontfixtures import _pdf

    def book(rotate: int) -> bytes:
        content = b"0 0 0 rg 50 30 100 50 re f"
        return _pdf([
            b"<< /Type /Catalog /Pages 2 0 R >>",
            b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
            b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 400 600] "
            b"/Rotate " + str(rotate).encode() +
            b" /Contents 4 0 R /Resources << >> >>",
            b"<< /Length " + str(len(content)).encode() +
            b" >>\nstream\n" + content + b"\nendstream",
        ])

    renders = {}
    for rot in (0, 90, 180, 270):
        p = tmp_path / f"r{rot}.pdf"
        p.write_bytes(book(rot))
        d = open_pdf(str(p))
        w, h = d.page_size(0)
        assert (w, h) == ((600.0, 400.0) if rot in (90, 270)
                          else (400.0, 600.0)), (rot, w, h)
        renders[rot] = np.asarray(d.render(0, dpi=72))
    for rot in (90, 180, 270):
        expect = np.rot90(renders[0], k=-(rot // 90))  # k=-1 is 90 deg CW
        assert renders[rot].shape == expect.shape
        assert (renders[rot] == expect).all(), f"rot {rot} mismatch"


def test_page_rotate_transforms_text_metadata(tmp_path):
    """Text block bboxes come out in rotated display space: for /Rotate
    90 a point (x, y) maps to display (y, x)."""
    make_test_book(str(tmp_path / "b.pdf"), pages=1, seed=3)
    data = (tmp_path / "b.pdf").read_bytes()
    i = data.find(b"/Type /Page ")
    assert i > 0
    # injecting /Rotate breaks xref offsets; the salvage path recovers
    (tmp_path / "b90.pdf").write_bytes(
        data[:i] + b"/Rotate 90 " + data[i:]
    )
    d0 = open_pdf(str(tmp_path / "b.pdf"))
    d9 = open_pdf(str(tmp_path / "b90.pdf"))
    assert d9.page_size(0) == tuple(reversed(d0.page_size(0)))
    # display-space mapping for /Rotate 90: an unrotated display bbox
    # [x0, y0, x1, y1] (y down) appears rotated with top-left
    # (ph - y1, x0), ph = unrotated page height. Block GROUPING may
    # differ between orientations (line merging is geometric), so
    # require a nonempty correspondence of top-left corners rather
    # than identical block sets.
    ph = d0.page_size(0)[1]
    expect9 = {
        (round(ph - b["bbox"][3], 1), round(b["bbox"][0], 1))
        for b in d0.page_text_blocks(0)
    }
    got9 = {(round(b["bbox"][0], 1), round(b["bbox"][1], 1))
            for b in d9.page_text_blocks(0)}
    assert got9 & expect9, (expect9, got9)


def test_cropbox_defines_display_page(tmp_path):
    """fitz displays the CropBox (∩ MediaBox); print-grade books keep
    crop marks in the MediaBox margin outside it. Page size, rendering,
    and clipping must all use the effective box."""
    from tests.fontfixtures import _pdf

    content = (b"0 0 0 rg 0 0 20 20 re f "        # mark outside the crop
               b"1 0 0 rg 100 100 100 100 re f")  # content inside
    pdf = _pdf([
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 700 900] "
        b"/CropBox [50 50 650 850] /Contents 4 0 R /Resources << >> >>",
        b"<< /Length " + str(len(content)).encode() +
        b" >>\nstream\n" + content + b"\nendstream",
    ])
    p = tmp_path / "crop.pdf"
    p.write_bytes(pdf)
    d = open_pdf(str(p))
    assert d.page_size(0) == (600.0, 800.0)
    arr = np.asarray(d.render(0, dpi=72))
    assert arr.shape == (800, 600, 3)
    red = arr[700, 100]
    assert red[0] > 220 and red[1] < 50, red.tolist()
    assert arr[795, 5].min() > 240  # crop mark clipped away


def test_smask_alpha_and_imagemask_stencil(tmp_path):
    """Image /SMask soft masks composite over existing content (logos
    with alpha), and /ImageMask stencils paint the CURRENT fill color
    through the mask — both rendered opaque before round 3."""
    import zlib

    from tests.fontfixtures import _pdf

    red = bytes([255, 0, 0] * 64)
    ramp = bytes([min(255, x * 36) for _ in range(8) for x in range(8)])
    stencil = bytes([0b10101010] * 8)  # sample 0 painted (Decode default)

    def obj_stream(dct: bytes, payload: bytes) -> bytes:
        z = zlib.compress(payload)
        return (dct + b" /Filter /FlateDecode /Length " +
                str(len(z)).encode() + b" >>\nstream\n" + z + b"\nendstream")

    content = (b"0 0 1 rg 50 492 200 200 re f "
               b"q 100 0 0 100 100 542 cm /Im1 Do Q "
               b"0 1 0 rg q 80 0 0 80 400 542 cm /Im2 Do Q")
    pdf = _pdf([
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 612 792] "
        b"/Contents 4 0 R /Resources << /XObject "
        b"<< /Im1 5 0 R /Im2 7 0 R >> >> >>",
        b"<< /Length " + str(len(content)).encode() +
        b" >>\nstream\n" + content + b"\nendstream",
        obj_stream(b"<< /Type /XObject /Subtype /Image /Width 8 /Height 8 "
                   b"/ColorSpace /DeviceRGB /BitsPerComponent 8 "
                   b"/SMask 6 0 R", red),
        obj_stream(b"<< /Type /XObject /Subtype /Image /Width 8 /Height 8 "
                   b"/ColorSpace /DeviceGray /BitsPerComponent 8", ramp),
        obj_stream(b"<< /Type /XObject /Subtype /Image /Width 8 /Height 8 "
                   b"/ImageMask true /BitsPerComponent 1", stencil),
    ])
    p = tmp_path / "smask.pdf"
    p.write_bytes(pdf)
    arr = np.asarray(open_pdf(str(p)).render(0, dpi=72))
    # SMask ramp: left edge transparent (blue bg shows), right opaque red
    left, right = arr[200, 105], arr[200, 195]
    assert left[2] > 150 and left[0] < 120, left.tolist()
    assert right[0] > 200 and right[2] < 80, right.tolist()
    # stencil stripes: texel centers alternate white / fill-green
    assert arr[200, 405].min() > 230, arr[200, 405].tolist()
    g = arr[200, 415]
    assert g[1] > 200 and g[0] < 60, g.tolist()


def test_inline_images_rasterize(tmp_path):
    """BI/ID/EI inline images (abbreviated keys, PDF 8.9.7) must
    actually draw — previously they were recorded as metadata only and
    vanished from renders. Covers inline RGB pixels and an inline
    /IM stencil painted in the current fill color."""
    import zlib

    from tests.fontfixtures import _pdf

    rgbpx = zlib.compress(bytes([0, 200, 0] * 16))  # 4x4 green
    stenc = zlib.compress(bytes([0b00110011] * 4))
    content = (
        b"q 100 0 0 100 50 600 cm BI /W 4 /H 4 /CS /RGB /BPC 8 /F /Fl "
        b"/L " + str(len(rgbpx)).encode() + b" ID " + rgbpx + b" EI Q "
        b"1 0 0 rg q 100 0 0 100 250 600 cm BI /W 4 /H 4 /IM true "
        b"/BPC 1 /F /Fl /L " + str(len(stenc)).encode() +
        b" ID " + stenc + b" EI Q")
    pdf = _pdf([
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 612 792] "
        b"/Contents 4 0 R /Resources << >> >>",
        b"<< /Length " + str(len(content)).encode() +
        b" >>\nstream\n" + content + b"\nendstream",
    ])
    p = tmp_path / "inline.pdf"
    p.write_bytes(pdf)
    arr = np.asarray(open_pdf(str(p)).render(0, dpi=72))
    g = arr[140, 100]
    assert g[1] > 150 and g[0] < 80, g.tolist()      # inline RGB drew
    r, wpx = arr[140, 262], arr[140, 337]
    assert r[0] > 200 and r[1] < 80, r.tolist()      # stencil fill color
    assert wpx.min() > 230, wpx.tolist()             # stencil hole


def test_dash_patterns_render(tmp_path):
    """`d` dash patterns render as on/off runs (dashed gridlines are
    ubiquitous in charts; solid rendering skews line/grid morphology vs
    the reference renderer). `[] 0 d` restores solid strokes."""
    from tests.fontfixtures import _pdf

    content = (b"2 w 0 0 0 RG [12 8] 0 d 50 700 m 550 700 l S "
               b"[] 0 d 50 650 m 550 650 l S "
               b"[6 6] 3 d 1 0 0 RG 50 600 m 550 600 l S")
    pdf = _pdf([
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 612 792] "
        b"/Contents 4 0 R /Resources << >> >>",
        b"<< /Length " + str(len(content)).encode() +
        b" >>\nstream\n" + content + b"\nendstream",
    ])
    p = tmp_path / "dash.pdf"
    p.write_bytes(pdf)
    arr = np.asarray(open_pdf(str(p)).render(0, dpi=72))

    def runs(row, ch):
        dark = arr[row, 50:550, ch] < 128
        return int(dark.sum()), int(np.abs(np.diff(dark.astype(int))).sum())

    on, trans = runs(92, 0)          # black dashed: many transitions
    assert trans > 20 and 200 < on < 450, (on, trans)
    on, trans = runs(142, 0)         # solid restored by [] 0 d
    assert trans <= 2 and on > 480, (on, trans)
    on, trans = runs(192, 1)         # red dash: probe green channel
    assert trans > 20 and 150 < on < 400, (on, trans)


def test_image_decode_array_inversion(tmp_path):
    """Image /Decode arrays remap samples — [1 0] inversion is routine
    on fax-scanned grayscale; ignoring it rendered such scans inverted."""
    import zlib

    from tests.fontfixtures import _pdf

    raw = zlib.compress(bytes([40] * 16))
    pdf = _pdf([
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 200 200] "
        b"/Contents 4 0 R /Resources << /XObject << /Im 5 0 R >> >> >>",
        b"<< /Length 34 >>\nstream\nq 100 0 0 100 50 50 cm /Im Do Q"
        b"\nendstream",
        b"<< /Type /XObject /Subtype /Image /Width 4 /Height 4 "
        b"/ColorSpace /DeviceGray /BitsPerComponent 8 /Decode [1 0] "
        b"/Filter /FlateDecode /Length " + str(len(raw)).encode() +
        b" >>\nstream\n" + raw + b"\nendstream",
    ])
    p = tmp_path / "dec.pdf"
    p.write_bytes(pdf)
    arr = np.asarray(open_pdf(str(p)).render(0, dpi=72))
    assert 205 < arr[100, 100, 0] < 225, arr[100, 100].tolist()


def test_optional_content_groups_hide_layers(tmp_path):
    """Content in OCGs the catalog's default config turns OFF must not
    render (print guides, alternate layers) — fitz honors /OCProperties
    /D /OFF the same way. Visible layers and unmarked content render
    normally."""
    from tests.fontfixtures import _pdf

    content = (b"/OC /L1 BDC 1 0 0 rg 20 200 60 50 re f EMC "
               b"/OC /L2 BDC 0 1 0 rg 120 200 60 50 re f EMC "
               b"0 0 1 rg 220 200 60 50 re f")
    pdf = _pdf([
        b"<< /Type /Catalog /Pages 2 0 R /OCProperties "
        b"<< /OCGs [5 0 R 6 0 R] /D << /ON [5 0 R] /OFF [6 0 R] >> >> >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 300 300] "
        b"/Contents 4 0 R /Resources "
        b"<< /Properties << /L1 5 0 R /L2 6 0 R >> >> >>",
        b"<< /Length " + str(len(content)).encode() +
        b" >>\nstream\n" + content + b"\nendstream",
        b"<< /Type /OCG /Name (visible) >>",
        b"<< /Type /OCG /Name (hidden) >>",
    ])
    p = tmp_path / "ocg.pdf"
    p.write_bytes(pdf)
    arr = np.asarray(open_pdf(str(p)).render(0, dpi=72))
    assert arr[75, 50][0] > 220 and arr[75, 50][1] < 40   # visible layer
    assert arr[75, 150].min() > 240                        # hidden layer
    assert arr[75, 250][2] > 220                           # unmarked


def _jp2_bytes(arr: np.ndarray) -> bytes:
    import io as _io

    from PIL import Image

    bio = _io.BytesIO()
    Image.fromarray(arr).save(bio, format="JPEG2000")  # reversible 5/3
    return bio.getvalue()


def _jpx_pdf(payload: bytes, w: int, h: int, cs: bytes = b"/DeviceRGB") -> bytes:
    from tests.fontfixtures import _pdf

    content = b"q 200 0 0 200 100 400 cm /Im1 Do Q"
    return _pdf([
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 612 792] "
        b"/Contents 4 0 R /Resources << /XObject << /Im1 5 0 R >> >> >>",
        b"<< /Length " + str(len(content)).encode() +
        b" >>\nstream\n" + content + b"\nendstream",
        b"<< /Type /XObject /Subtype /Image /Width " + str(w).encode() +
        b" /Height " + str(h).encode() + b" /ColorSpace " + cs +
        b" /BitsPerComponent 8 /Filter /JPXDecode /Length " +
        str(len(payload)).encode() + b" >>\nstream\n" + payload +
        b"\nendstream",
    ])


def test_jpx_image_decodes_via_host_codec(tmp_path):
    """JPEG2000 (JPXDecode) images decode to real pixels through the
    registered PIL/OpenJPEG host callback — validated against the encoder
    of an independent toolchain (OpenJPEG wrote the codestream; the spdf
    decode path must reproduce the source array). Was a neutral-gray
    plate degrade before round 3."""
    rng = np.random.default_rng(11)
    src = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
    p = tmp_path / "jpx.pdf"
    p.write_bytes(_jpx_pdf(_jp2_bytes(src), 32, 32))
    doc = open_pdf(str(p))
    ims = doc.page_images(0)
    assert len(ims) == 1
    arr = doc.decode_image(ims[0]["obj"])
    assert arr.shape == (32, 32, 3)
    assert np.array_equal(arr, src)  # 5/3 reversible: bit-exact


def test_jpx_image_renders_real_pixels(tmp_path):
    """A JPX image placed on the page rasterizes with its actual colors
    (solid red field), not the old 200-gray plate."""
    src = np.zeros((16, 16, 3), np.uint8)
    src[..., 0] = 220
    p = tmp_path / "jpx_render.pdf"
    p.write_bytes(_jpx_pdf(_jp2_bytes(src), 16, 16))
    arr = np.asarray(open_pdf(str(p)).render(0, dpi=72))
    px = arr[792 - 500, 200]  # mid-image in raster coords
    assert px[0] > 180 and px[1] < 60 and px[2] < 60, px.tolist()


def test_jpx_grayscale_and_corrupt_fallback(tmp_path):
    """Grayscale JP2 expands to RGB; a corrupt codestream is a failed
    decode — no pixels, no silent stand-in plate — that detection logs and
    counts, while the page still renders."""
    ramp = np.tile(np.arange(0, 256, 16, dtype=np.uint8), (16, 1))
    p = tmp_path / "jpx_gray.pdf"
    p.write_bytes(_jpx_pdf(_jp2_bytes(ramp), 16, 16, cs=b"/DeviceGray"))
    arr = open_pdf(str(p)).decode_image(open_pdf(str(p)).page_images(0)[0]["obj"])
    assert arr.shape == (16, 16, 3)
    assert np.array_equal(arr[..., 0], arr[..., 1])
    assert abs(int(arr[8, 15, 0]) - 240) <= 2 and arr[8, 0, 0] <= 2
    q = tmp_path / "jpx_bad.pdf"
    q.write_bytes(_jpx_pdf(b"\xff\x4f\xff\x51 garbage not a codestream", 16, 16))
    doc = open_pdf(str(q))
    assert doc.decode_image(doc.page_images(0)[0]["obj"]) is None
    page = doc.render(0, dpi=72)
    assert page[792 - 500, 200].min() > 240  # nothing drawn for the image
    from synapta_tpu.vision.detect import DetectionEngine

    engine = DetectionEngine(doc)
    assert engine.detect_page(0) == []
    assert engine.decode_failures == 1
