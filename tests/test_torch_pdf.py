"""The port's built-in PDF input against the JAX package's, array for
array, on the CPU.

``utils/pdf.py``, ``utils/pdf_render.py`` and ``utils/font_glyphs.py``
are copies (held line for line in ``test_torch_host_copies.py``); here
both packages render the same files: the fixtures the JAX PDF tests
build (``test_pdf_render.py``, ``test_pdf_fonts.py``,
``test_utils_extra.py``; their builders are imported, not copied) and
matplotlib's TrueType (``pdf.fonttype`` 42) and Type3 output. Covered:
the classic vector page, the object-stream page, TrueType, CFF, Type1
and Type3 fonts, inline images, the scanned (embedded JPEG) pages of
``extract_scanned_pages``, and the actionable error for a file out of
scope.

The port's stream readers deviate from the copies in one place: they
slice a stream by its ``/Length`` (an indirect one resolved) and strip
one end-of-line marker at most, where the JAX package strips every
trailing CR and LF and so cuts compressed data that ends in such a byte.
On those files the JAX package raises and the port renders: a matplotlib
TrueType page of 4×2 inches (indirect ``/Length``), and pages whose
Flate content or image ends in an LF or CR byte (direct ``/Length``).
There the port's pages are held to the same drawing stored uncompressed,
which both packages render alike.
"""

import zlib

import numpy as np
import pytest

import test_pdf_fonts as fonts_fx
import test_pdf_render as render_fx
import test_utils_extra as extra_fx
from oar_ocr_tpu.utils import pdf as j_pdf
from oar_ocr_tpu.utils import pdf_render as j_pdf_render
from oar_ocr_tpu_torch.utils import pdf, pdf_render


def _font_page(tmp_path, name, font, descriptor, file_dict, blob, content):
    objs = {
        1: b"<< /Type /Catalog /Pages 2 0 R >>",
        2: (b"<< /Type /Pages /Kids [3 0 R] /Count 1 "
            b"/MediaBox [0 0 300 300] >>"),
        3: (b"<< /Type /Page /Parent 2 0 R /Resources "
            b"<< /Font << /F1 4 0 R >> >> /Contents 5 0 R >>"),
        4: font,
        5: b"<< /Length %d >>" % len(content),
        6: descriptor,
        7: file_dict,
    }
    return fonts_fx._write_pdf(tmp_path, name, objs, {5: content, 7: blob})


def _matplotlib_pdf(tmp_path, fonttype, figsize=(6, 4)):
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    import matplotlib.pyplot as plt

    with mpl.rc_context({"pdf.fonttype": fonttype}):
        fig = plt.figure(figsize=figsize)
        fig.text(0.1, 0.5, f"Type {fonttype} glyphs", fontsize=22)
        p = tmp_path / f"mpl{fonttype}_{figsize[0]}x{figsize[1]}.pdf"
        fig.savefig(str(p))
        plt.close(fig)
    return str(p)


def _inline_pdf(tmp_path):
    rgb = np.zeros((2, 2, 3), np.uint8)
    rgb[:, 0] = [255, 0, 0]
    rgb[:, 1] = [0, 0, 255]
    content = (b"q 200 0 0 100 50 250 cm BI /W 2 /H 2 /BPC 8 /CS /G ID "
               + bytes([0, 255, 0, 255]) + b" EI Q\n"
               b"q 100 0 0 100 50 100 cm BI /W 2 /H 2 /BPC 8 /CS /RGB "
               b"/F /Fl ID " + zlib.compress(rgb.tobytes()) + b" EI Q\n"
               b"q 1 0 0 rg 80 0 0 80 260 60 cm BI /IM true /W 2 /H 2 "
               b"/BPC 1 ID " + bytes([0b01000000, 0b10000000]) + b" EI Q\n"
               b"0 0 0 rg 300 320 50 50 re f")
    return fonts_fx._one_page_pdf(tmp_path, "inline.pdf", content)


def _build(kind, tmp_path):
    """(path, [(function name, kwargs)]) for one fixture."""
    if kind == "classic":
        return render_fx._classic_pdf(tmp_path), [
            ("render_pdf", {"dpi": 100}), ("render_pdf", {"dpi": 72,
                                                          "pages": [1]})]
    if kind == "objstm":
        return render_fx._objstm_pdf(tmp_path), [
            ("render_vector_pdf", {"dpi": 144})]
    if kind in ("truetype", "type3"):
        return _matplotlib_pdf(tmp_path, 42 if kind == "truetype" else 3), [
            ("render_vector_pdf", {"dpi": 100})]
    if kind == "truetype_small":
        # an indirect /Length; the compressed data ends in CR or LF
        return _matplotlib_pdf(tmp_path, 42, (4, 2)), [
            ("render_vector_pdf", {"dpi": 100})]
    if kind == "cff":
        otf = fonts_fx._build_cff_otf()
        return _font_page(
            tmp_path, "cff.pdf",
            b"<< /Type /Font /Subtype /Type1 /BaseFont /T /FirstChar 65 "
            b"/LastChar 65 /Widths [600] /FontDescriptor 6 0 R >>",
            b"<< /Type /FontDescriptor /FontName /T /Flags 4 "
            b"/FontFile3 7 0 R >>",
            b"<< /Subtype /Type1C /Length %d >>" % len(otf), otf,
            b"BT /F1 48 Tf 100 150 Td (AA A) Tj ET"), [
            ("render_vector_pdf", {"dpi": 150})]
    if kind == "type1":
        t1 = fonts_fx._build_type1()
        return _font_page(
            tmp_path, "t1.pdf",
            b"<< /Type /Font /Subtype /Type1 /BaseFont /TestT1 "
            b"/FirstChar 65 /LastChar 65 /Widths [600] "
            b"/FontDescriptor 6 0 R >>",
            b"<< /Type /FontDescriptor /FontName /TestT1 /Flags 4 "
            b"/FontFile 7 0 R >>",
            b"<< /Length %d /Length1 64 /Length2 %d /Length3 0 >>"
            % (len(t1), len(t1) - 64), t1,
            b"BT /F1 50 Tf 80 200 Td (A) Tj ET"), [
            ("render_vector_pdf", {"dpi": 144})]
    if kind == "inline":
        return _inline_pdf(tmp_path), [("render_vector_pdf", {"dpi": 72})]
    # scanned: one embedded JPEG a page
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 255, (64, 48, 3), np.uint8),
            np.full((80, 60, 3), 200, np.uint8)]
    imgs[1][10:30, 5:40] = 20
    path = str(tmp_path / "scan.pdf")
    extra_fx.TestBuiltinScannedPdf._make_scanned_pdf(path, imgs)
    return path, [("render_pdf", {}), ("render_pdf", {"pages": [1]}),
                  ("extract_scanned_pages", {})]


def _content_ending_in(last: int) -> bytes:
    """A page's drawing whose zlib stream ends in the byte ``last``."""
    for i in range(4096):
        content = (b"0 0 0 rg 60 60 %d 40 re f 0.5 g 100 200 120 50 re f"
                   % (100 + i % 256) + b" " * (i // 256))
        if zlib.compress(content)[-1] == last:
            return content
    raise AssertionError("no content found")


def _flate_page(tmp_path, name, content, compressed):
    body = zlib.compress(content) if compressed else content
    head = b"<< /Length %d%s >>" % (
        len(body), b" /Filter /FlateDecode" if compressed else b"")
    objs = {
        1: b"<< /Type /Catalog /Pages 2 0 R >>",
        2: (b"<< /Type /Pages /Kids [3 0 R] /Count 1 "
            b"/MediaBox [0 0 400 400] >>"),
        3: (b"<< /Type /Page /Parent 2 0 R /Resources << >> "
            b"/Contents 5 0 R >>"),
        5: head,
    }
    return fonts_fx._write_pdf(tmp_path, name, objs, {5: body})


def _flate_image_pdf(tmp_path, name, last, indirect):
    """One page holding a Flate RGB image whose compressed bytes end in
    ``last``, its /Length direct or an indirect reference; returns the
    path and the image."""
    rng = np.random.default_rng(int(last))
    for _ in range(4096):
        img = rng.integers(0, 255, (24, 20, 3), np.uint8)
        data = zlib.compress(img.tobytes())
        if data[-1] == last:
            break
    else:
        raise AssertionError("no image found")
    length = b"7 0 R" if indirect else b"%d" % len(data)
    objs = {
        1: b"<< /Type /Catalog /Pages 2 0 R >>",
        2: b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        3: (b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 20 24] "
            b"/Resources << /XObject << /Im0 4 0 R >> >> >>"),
        4: (b"<< /Type /XObject /Subtype /Image /Width 20 /Height 24 "
            b"/ColorSpace /DeviceRGB /BitsPerComponent 8 "
            b"/Filter /FlateDecode /Length " + length + b" >>"),
        7: b"%d" % len(data),
    }
    return fonts_fx._write_pdf(tmp_path, name, objs, {4: data}), img


@pytest.mark.parametrize("last", [10, 13])
def test_stream_ending_in_eol_renders(last, tmp_path):
    """Flate content whose last compressed byte is LF or CR, with a direct
    /Length: the JAX reader strips that byte and fails; the port renders
    the page as the same drawing stored uncompressed."""
    content = _content_ending_in(last)
    packed = _flate_page(tmp_path, "packed.pdf", content, True)
    plain = _flate_page(tmp_path, "plain.pdf", content, False)
    ref = j_pdf_render.render_vector_pdf(plain, dpi=72)
    assert np.array_equal(pdf_render.render_vector_pdf(plain, dpi=72)[0],
                          ref[0])
    ours = pdf_render.render_vector_pdf(packed, dpi=72)
    assert np.array_equal(ours[0], ref[0]) and (ours[0] < 128).any()
    assert _outcome(j_pdf_render, "render_vector_pdf", packed,
                    {"dpi": 72})[0] == "error"   # zlib.error


@pytest.mark.parametrize("last,indirect", [(10, False), (13, True)])
def test_scanned_flate_ending_in_eol(last, indirect, tmp_path):
    """A scanned page's Flate image ending in LF or CR: the port extracts
    the image exactly; the JAX extractor fails to inflate it."""
    path, img = _flate_image_pdf(tmp_path, "scan_eol.pdf", last, indirect)
    (got,) = pdf.extract_scanned_pages(path)
    assert np.array_equal(got, img)
    assert _outcome(j_pdf, "extract_scanned_pages", path,
                    {})[0] == "UnsupportedError"


def _outcome(mod, fn, path, kw):
    """The pages, or (error class name, message)."""
    try:
        return getattr(mod, fn)(path, **kw)
    except Exception as e:  # noqa: BLE001 — compared between packages
        return type(e).__name__, str(e)


@pytest.mark.parametrize("kind", ["classic", "objstm", "truetype",
                                  "truetype_small", "type3", "cff", "type1",
                                  "inline", "scanned"])
def test_render_matches_jax(kind, tmp_path):
    path, calls = _build(kind, tmp_path)
    for fn, kw in calls:
        vector = fn == "render_vector_pdf"
        ours = _outcome(pdf_render if vector else pdf, fn, path, kw)
        ref = _outcome(j_pdf_render if vector else j_pdf, fn, path, kw)
        if kind == "truetype_small":
            # JAX raises; the port renders the page
            assert ref[0] == "error", ref
            assert len(ours) == 1 and (ours[0] < 128).any()
            wide = pdf_render.render_vector_pdf(
                _matplotlib_pdf(tmp_path, 42), **kw)
            assert ours[0].dtype == wide[0].dtype == np.uint8
            continue
        assert len(ours) == len(ref) > 0
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
            assert np.array_equal(a, b)
        assert any((p < 128).any() for p in ours), "blank render"


def test_out_of_scope_errors_match(tmp_path):
    junk = tmp_path / "junk.pdf"
    junk.write_bytes(b"%PDF-1.4\nthis is not really a pdf body\n%%EOF")
    text = tmp_path / "not.pdf"
    text.write_bytes(b"hello")
    vector = tmp_path / "vec.pdf"
    vector.write_bytes(b"%PDF-1.4\n1 0 obj\n<< /Type /Catalog >>\nendobj\n"
                       b"%%EOF")
    for fn, path in (("render_pdf", junk), ("render_pdf", text),
                     ("extract_scanned_pages", vector)):
        with pytest.raises(Exception) as ours:
            getattr(pdf, fn)(str(path))
        with pytest.raises(Exception) as ref:
            getattr(j_pdf, fn)(str(path))
        assert type(ours.value).__name__ == type(ref.value).__name__ == \
            "UnsupportedError"
        assert str(ours.value) == str(ref.value)
        assert ours.value.context == ref.value.context
