"""The first-party baseline JPEG decoder (native/src/jpeg.cc) against
libjpeg's output, as Pillow decodes the same bytes: gray, YCbCr and
Adobe CMYK, every chroma subsampling, restart intervals, and odd sizes
whose MCUs overhang the image edge."""
import io

import numpy as np
import pytest

from synapta_tpu.io.ingest import Document

Image = pytest.importorskip("PIL.Image")


def _pdf_with_jpeg(jpg: bytes, w: int, h: int, cs: bytes) -> bytes:
    from tests.fontfixtures import _pdf

    content = b"q 200 0 0 200 100 400 cm /Im1 Do Q"
    return _pdf([
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 612 792] "
        b"/Contents 4 0 R /Resources << /XObject << /Im1 5 0 R >> >> >>",
        b"<< /Length " + str(len(content)).encode() +
        b" >>\nstream\n" + content + b"\nendstream",
        b"<< /Type /XObject /Subtype /Image /Width %d /Height %d "
        b"/ColorSpace " % (w, h) + cs + b" /BitsPerComponent 8 "
        b"/Filter /DCTDecode /Length %d >>\nstream\n" % len(jpg) + jpg +
        b"\nendstream",
    ])


def _decode_native(jpg: bytes, w: int, h: int, cs: bytes):
    doc = Document(data=_pdf_with_jpeg(jpg, w, h, cs))
    return doc.decode_image(doc.page_images(0)[0]["obj"])


def _photo(h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([127 + 100 * np.sin(xx / 7.0 + c) * np.cos(yy / 11.0 - c)
                  for c in range(3)], -1)
    return np.clip(a + rng.normal(0, 20, a.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("mode", ["RGB", "L", "CMYK"])
@pytest.mark.parametrize("subsampling", [0, 1, 2])  # 4:4:4, 4:2:2, 4:2:0
@pytest.mark.parametrize("size", [(37, 53), (180, 300), (2, 17)])
def test_decoder_matches_libjpeg(mode, subsampling, size):
    h, w = size
    arr = _photo(h, w, seed=h * w)
    for quality, restart in ((50, None), (90, 3), (100, None)):
        bio = io.BytesIO()
        kw = {"quality": quality, "subsampling": subsampling}
        if restart:
            kw["restart_marker_blocks"] = restart
        Image.fromarray(arr).convert(mode).save(bio, format="JPEG", **kw)
        jpg = bio.getvalue()
        ref = Image.open(io.BytesIO(jpg))
        ref.load()
        if mode == "CMYK":
            # Pillow un-inverts Adobe CMYK; the engine composites ink
            c, m, y, k = (np.asarray(ref).astype(int)[..., i] for i in range(4))
            want = np.stack([(255 - c) * (255 - k) // 255,
                             (255 - m) * (255 - k) // 255,
                             (255 - y) * (255 - k) // 255], -1)
            cs = b"/DeviceCMYK"
        elif mode == "L":
            want = np.repeat(np.asarray(ref)[..., None], 3, -1)
            cs = b"/DeviceGray"
        else:
            want = np.asarray(ref.convert("RGB"))
            cs = b"/DeviceRGB"
        got = _decode_native(jpg, w, h, cs)
        assert got is not None and got.shape == (h, w, 3)
        np.testing.assert_array_equal(got.astype(int), want.astype(int))


def test_progressive_and_corrupt_streams_fail_cleanly():
    """Progressive JPEG is outside the baseline decoder: the decode fails
    (no pixels) instead of painting a wrong image; so does garbage."""
    arr = _photo(40, 40, seed=3)
    bio = io.BytesIO()
    Image.fromarray(arr).save(bio, format="JPEG", progressive=True)
    assert _decode_native(bio.getvalue(), 40, 40, b"/DeviceRGB") is None
    assert _decode_native(b"\xff\xd8\xff\xdb garbage", 40, 40,
                          b"/DeviceRGB") is None


def test_truncated_stream_decodes_what_arrived():
    """A stream cut mid-scan decodes like libjpeg: the blocks that arrived
    are right, the rest come out flat instead of failing the page."""
    arr = _photo(64, 64, seed=5)
    bio = io.BytesIO()
    Image.fromarray(arr).save(bio, format="JPEG", quality=90, subsampling=0)
    jpg = bio.getvalue()
    got = _decode_native(jpg[: len(jpg) * 2 // 3], 64, 64, b"/DeviceRGB")
    full = _decode_native(jpg, 64, 64, b"/DeviceRGB")
    assert got is not None and got.shape == (64, 64, 3)
    np.testing.assert_array_equal(got[:8], full[:8])
