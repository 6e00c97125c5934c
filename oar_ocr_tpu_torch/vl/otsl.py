"""OTSL ↔ HTML conversion for VLM table output.

Re-expresses oar-ocr-vl/src/utils/table.rs (906 LoC) faithfully: several
VLM families emit tables in OTSL (Open Table Structure Language) — cell
tokens ``<fcel>`` (content cell), ``<ecel>`` (empty), ``<lcel>`` (merge
with the cell to the left), ``<ucel>`` (merge with the cell above),
``<xcel>`` (merge left+up) and ``<nl>`` row separators, with each cell's
text following its token.

The forward converter (table.rs:193 ``convert_otsl_to_html``) dispatches:
already-HTML input is repaired in place (:217 ``clean_html_table``),
token input runs the PaddleX-compatible pipeline — square-pad repair with
optimal-width search (:300 ``otsl_pad_to_sqr_v2``), token/text extraction
(:394), span counting (:417 ``otsl_parse_texts``) and HTML export with
entity escaping (:563 ``otsl_export_to_html``) — with a token-strip
fallback (:255) when parsing fails, and tag-free text converts as simple
TSV (:229). The inverse (:44 ``convert_html_to_otsl``) parses HTML rows/
cells back onto a span grid and emits tokens.

Extension beyond the reference: Docling-style header tokens ``<ched>`` /
``<rhed>`` (emitted by some table-structure checkpoints) are accepted as
content-cell starters and exported as ``<th>``; ``<srow>`` is treated as
a plain content cell. The reference tokenizer does not know these and
would smear them into neighbouring cell text. For inputs containing only
the six reference tokens the output is byte-identical to the reference.

The port's copy of ``oar_ocr_tpu/vl/otsl.py`` (:1-482), line for line;
only this paragraph is new. ``tests/test_torch_host_copies.py`` holds it
to the original.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from html import escape as _html_escape
from typing import List, Optional, Sequence, Tuple

OTSL_NL = "<nl>"
OTSL_FCEL = "<fcel>"
OTSL_ECEL = "<ecel>"
OTSL_LCEL = "<lcel>"
OTSL_UCEL = "<ucel>"
OTSL_XCEL = "<xcel>"

# reference token set (table.rs:8) + the documented header extension
_OTSL_TOKEN_RE = re.compile(
    r"(<fcel>|<lcel>|<ucel>|<xcel>|<ecel>|<nl>|<ched>|<rhed>|<srow>)")

# tokens that OPEN a cell carrying content ("<fcel>"-class)
_CONTENT_STARTERS = frozenset(("<fcel>", "<ched>", "<rhed>", "<srow>"))
_HEADER_STARTERS = frozenset(("<ched>", "<rhed>"))
_ALL_CELL_TOKENS = _CONTENT_STARTERS | {OTSL_ECEL, OTSL_LCEL, OTSL_UCEL,
                                        OTSL_XCEL}


def looks_like_table_tokens(text: str) -> bool:
    """table.rs:246 — any OTSL token present."""
    return bool(_OTSL_TOKEN_RE.search(text))


def needs_table_postprocess(text: str) -> bool:
    """True when the backend emitted OTSL rather than HTML (the text-
    sniffing analog of doc_parser.rs:61's per-backend flag)."""
    return looks_like_table_tokens(text) and "<table" not in text.lower()


def clean_html_table(text: str) -> str:
    """Repair common attribute typos + strip stray model tokens
    (table.rs:217-228); replacement order matches the reference."""
    result = text
    result = result.replace("<tdcolspan=", "<td colspan=")
    result = result.replace("<tdrowspan=", "<td rowspan=")
    result = result.replace("colspan=", " colspan=")
    result = result.replace("<|sn|>", "")
    result = result.replace("<|unk|>", "")
    result = result.replace("￿", "")
    return result


def simple_otsl_conversion(text: str) -> str:
    """Tag-free text treated as TSV (table.rs:229-245)."""
    html = ["<table>"]
    for line in text.splitlines():
        if not line.strip():
            continue
        html.append("<tr>")
        for cell in line.split("\t"):
            html.append(f"<td>{_html_escape(cell.strip(), quote=False)}"
                        "</td>")
        html.append("</tr>")
    html.append("</table>")
    return "".join(html)


def strip_table_tokens_fallback(text: str) -> str:
    """Last-resort de-tokenization when grid parsing fails
    (table.rs:255-267)."""
    out = text.replace(OTSL_ECEL, "\n").replace(OTSL_NL, "\n")
    out = (out.replace(OTSL_FCEL, "\t").replace("<ched>", "\t")
              .replace("<rhed>", "\t").replace("<srow>", "\t")
              .replace(OTSL_LCEL, "").replace(OTSL_UCEL, "")
              .replace(OTSL_XCEL, ""))
    lines = [ln.strip() for ln in out.splitlines()]
    return "\n".join(ln for ln in lines if ln)


def convert_otsl_to_html(text: str) -> str:
    """Convert OTSL table tokens (or HTML, or TSV text) to an HTML table
    (table.rs:193-215)."""
    trimmed = text.strip()
    if not trimmed:
        return ""
    if "<table" in trimmed:
        return clean_html_table(trimmed)
    if looks_like_table_tokens(trimmed):
        html = _try_convert_table_tokens_to_html(trimmed)
        if html is not None:
            return html
        return strip_table_tokens_fallback(trimmed)
    return simple_otsl_conversion(trimmed)


# kept name from earlier rounds; all pipelines call this
otsl_to_html = convert_otsl_to_html


# --------------------- token-grid pipeline ---------------------

def split_otsl_segments(line: str) -> List[str]:
    """Split one OTSL line into per-token segments; leading text before
    the first token joins the first segment (table.rs:365-392)."""
    matches = list(_OTSL_TOKEN_RE.finditer(line))
    if not matches:
        return []
    segments = []
    first_start = matches[0].start()
    for idx, m in enumerate(matches):
        start = 0 if idx == 0 else m.start()
        end = matches[idx + 1].start() if idx + 1 < len(matches) \
            else len(line)
        if idx == 0 and first_start == 0:
            segments.append(line[m.start():end])
        else:
            segments.append(line[start:end])
    return segments


def otsl_pad_to_sqr_v2(otsl_str: str) -> str:
    """Repair ragged rows to a uniform width chosen by L1-cost search
    over [widest content column, max row length] (table.rs:300-363)."""
    otsl_str = otsl_str.strip()
    if OTSL_NL not in otsl_str:
        return otsl_str + OTSL_NL
    row_segments: List[List[str]] = []
    row_lengths: List[int] = []
    row_min_lengths: List[int] = []
    for line in otsl_str.split(OTSL_NL):
        if not line:
            continue
        segments = split_otsl_segments(line)
        if not segments:
            continue
        min_len = 0
        for i, seg in enumerate(segments):
            if any(seg.startswith(tok) for tok in _CONTENT_STARTERS):
                min_len = i + 1
        row_segments.append(segments)
        row_lengths.append(len(segments))
        row_min_lengths.append(min_len)
    if not row_segments:
        return OTSL_NL
    global_min_width = max(row_min_lengths) if row_min_lengths else 0
    max_total_len = max(row_lengths) if row_lengths else 0
    search_end = max(global_min_width, max_total_len)
    min_total_cost = None
    optimal_width = search_end
    for width in range(global_min_width, search_end + 1):
        cost = sum(abs(length - width) for length in row_lengths)
        if min_total_cost is None or cost < min_total_cost:
            min_total_cost = cost
            optimal_width = width
    repaired = []
    for segments in row_segments:
        if len(segments) > optimal_width:
            segments = segments[:optimal_width]
        elif len(segments) < optimal_width:
            segments = segments + [OTSL_ECEL] * (optimal_width
                                                 - len(segments))
        repaired.append("".join(segments))
    return OTSL_NL.join(repaired) + OTSL_NL


def otsl_extract_tokens_and_text(text: str
                                 ) -> Tuple[List[str], List[str]]:
    """→ (tokens, interleaved tokens+texts) (table.rs:394-415)."""
    tokens: List[str] = []
    parts: List[str] = []
    last = 0
    for m in _OTSL_TOKEN_RE.finditer(text):
        before = text[last:m.start()]
        if before.strip():
            parts.append(before)
        tokens.append(m.group(0))
        parts.append(m.group(0))
        last = m.end()
    trailing = text[last:]
    if trailing.strip():
        parts.append(trailing)
    return tokens, parts


@dataclass
class _TableCell:
    """table.rs:289-298 TableCell (+ header extension)."""

    row_span: int
    col_span: int
    start_row: int
    end_row: int
    start_col: int
    end_col: int
    text: str
    header: bool = False


def _is_otsl_tag(token: str) -> bool:
    return token == OTSL_NL or token in _ALL_CELL_TOKENS


def _is_l_or_x(token: str) -> bool:
    return token in (OTSL_LCEL, OTSL_XCEL)


def _is_u_or_x(token: str) -> bool:
    return token in (OTSL_UCEL, OTSL_XCEL)


def otsl_parse_texts(texts: Sequence[str], tokens: Sequence[str]
                     ) -> Tuple[List[_TableCell], List[List[str]]]:
    """Token/text stream → cells with resolved spans + row-token grid
    (table.rs:417-554)."""
    split_row_tokens: List[List[str]] = []
    current: List[str] = []
    for token in tokens:
        if token == OTSL_NL:
            if current:
                split_row_tokens.append(current)
                current = []
        else:
            current.append(token)
    if current:
        split_row_tokens.append(current)

    normalized = list(texts)
    if split_row_tokens:
        max_cols = max(len(r) for r in split_row_tokens)
        for row in split_row_tokens:
            while len(row) < max_cols:
                row.append(OTSL_ECEL)
        new_texts: List[str] = []
        text_idx = 0
        for row in split_row_tokens:
            for token in row:
                new_texts.append(token)
                if text_idx < len(normalized) \
                        and normalized[text_idx] == token:
                    text_idx += 1
                    if text_idx < len(normalized) \
                            and not _is_otsl_tag(normalized[text_idx]):
                        new_texts.append(normalized[text_idx])
                        text_idx += 1
            new_texts.append(OTSL_NL)
            if text_idx < len(normalized) \
                    and normalized[text_idx] == OTSL_NL:
                text_idx += 1
        normalized = new_texts

    def count_right(c_idx: int, r_idx: int) -> int:
        span = 0
        c = c_idx
        while (r_idx < len(split_row_tokens)
               and c < len(split_row_tokens[r_idx])
               and _is_l_or_x(split_row_tokens[r_idx][c])):
            span += 1
            c += 1
        return span

    def count_down(c_idx: int, r_idx: int) -> int:
        span = 0
        r = r_idx
        while (r < len(split_row_tokens)
               and c_idx < len(split_row_tokens[r])
               and _is_u_or_x(split_row_tokens[r][c_idx])):
            span += 1
            r += 1
        return span

    cells: List[_TableCell] = []
    r_idx = 0
    c_idx = 0
    for i, text in enumerate(normalized):
        if text in _CONTENT_STARTERS or text == OTSL_ECEL:
            row_span = 1
            col_span = 1
            right_offset = 1
            cell_text = ""
            if text != OTSL_ECEL:
                cell_text = normalized[i + 1] if i + 1 < len(normalized) \
                    else ""
                right_offset = 2
            next_right = normalized[i + right_offset] \
                if i + right_offset < len(normalized) else ""
            if (r_idx + 1 < len(split_row_tokens)
                    and c_idx < len(split_row_tokens[r_idx + 1])):
                next_bottom = split_row_tokens[r_idx + 1][c_idx]
            else:
                next_bottom = ""
            if _is_l_or_x(next_right):
                col_span += count_right(c_idx + 1, r_idx)
            if _is_u_or_x(next_bottom):
                row_span += count_down(c_idx, r_idx + 1)
            cells.append(_TableCell(
                row_span=row_span, col_span=col_span,
                start_row=r_idx, end_row=r_idx + row_span,
                start_col=c_idx, end_col=c_idx + col_span,
                text=cell_text.strip(),
                header=text in _HEADER_STARTERS))
        if text in _ALL_CELL_TOKENS:
            c_idx += 1
        if text == OTSL_NL:
            r_idx += 1
            c_idx = 0
    return cells, split_row_tokens


def otsl_export_to_html(cells: Sequence[_TableCell], num_rows: int,
                        num_cols: int) -> str:
    """Cells → HTML grid; rowspan attr before colspan, entity-escaped
    content (table.rs:563-608)."""
    if not cells:
        return ""
    grid: List[List[Optional[int]]] = [[None] * num_cols
                                       for _ in range(num_rows)]
    for idx, cell in enumerate(cells):
        for r in range(cell.start_row, min(cell.end_row, num_rows)):
            for c in range(cell.start_col, min(cell.end_col, num_cols)):
                grid[r][c] = idx
    body = []
    for i in range(num_rows):
        body.append("<tr>")
        for j in range(num_cols):
            idx = grid[i][j]
            if idx is None:
                continue
            cell = cells[idx]
            if cell.start_row != i or cell.start_col != j:
                continue
            tag = "th" if cell.header else "td"
            opening = tag
            if cell.row_span > 1:
                opening += f' rowspan="{cell.row_span}"'
            if cell.col_span > 1:
                opening += f' colspan="{cell.col_span}"'
            content = _html_escape(cell.text.strip(), quote=False)
            body.append(f"<{opening}>{content}</{tag}>")
        body.append("</tr>")
    return "<table>" + "".join(body) + "</table>"


def _try_convert_table_tokens_to_html(text: str) -> Optional[str]:
    """table.rs:269-287."""
    padded = otsl_pad_to_sqr_v2(text)
    tokens, texts = otsl_extract_tokens_and_text(padded)
    if not tokens:
        return None
    cells, split_row_tokens = otsl_parse_texts(texts, tokens)
    num_rows = len(split_row_tokens)
    num_cols = max((len(r) for r in split_row_tokens), default=0)
    if num_rows == 0 or num_cols == 0:
        return None
    html = otsl_export_to_html(cells, num_rows, num_cols)
    return html or None


# --------------------- HTML → OTSL (inverse) ---------------------

_TR_RE = re.compile(r"<tr[^>]*>(.*?)</tr>", re.IGNORECASE | re.DOTALL)
_TR_OPEN_RE = re.compile(r"<tr[\s>]", re.IGNORECASE)
_CELL_RE = re.compile(r"<t[dh]([^>]*)>(.*?)</t[dh]>",
                      re.IGNORECASE | re.DOTALL)
_STRIP_TAG_RE = re.compile(r"<[^>]*>")
# anchored so data-colspan= / class="mycolspan" don't trip the scanner
_COLSPAN_RE = re.compile(r'(?:^|\s)colspan\s*=\s*"?(\d+)"?',
                         re.IGNORECASE)
_ROWSPAN_RE = re.compile(r'(?:^|\s)rowspan\s*=\s*"?(\d+)"?',
                         re.IGNORECASE)


def _extract_span(attrs: str, name: str) -> int:
    re_ = _COLSPAN_RE if name == "colspan" else _ROWSPAN_RE
    m = re_.search(attrs)
    if m is None:
        return 1
    try:
        n = int(m.group(1))
    except ValueError:
        return 1
    return n if n > 0 else 1


def _clean_cell_text(body: str) -> str:
    """Strip nested tags + decode the entities the forward converter
    emits (table.rs:176-191)."""
    stripped = _STRIP_TAG_RE.sub("", body)
    decoded = (stripped.replace("&amp;", "&").replace("&lt;", "<")
               .replace("&gt;", ">").replace("&quot;", '"')
               .replace("&#x27;", "'"))
    return decoded.strip()


def convert_html_to_otsl(text: str) -> Optional[str]:
    """Inverse converter: HTML ``<table>`` snippet → raw OTSL token form
    (table.rs:44-146). Returns None for empty / non-table / cell-less
    input so callers can skip the draft."""
    trimmed = text.strip()
    if not trimmed or not _TR_OPEN_RE.search(trimmed):
        return None
    repaired = (trimmed.replace("<tdcolspan=", "<td colspan=")
                .replace("<tdrowspan=", "<td rowspan="))
    # rows preserve empties: a <tr></tr> consumed by a rowspan still
    # counts toward the grid's row count
    rows: List[List[Tuple[int, int, str]]] = []
    for tr in _TR_RE.finditer(repaired):
        cells = []
        for cm in _CELL_RE.finditer(tr.group(1)):
            attrs = cm.group(1) or ""
            body = cm.group(2) or ""
            cells.append((_extract_span(attrs, "rowspan"),
                          _extract_span(attrs, "colspan"),
                          _clean_cell_text(body)))
        rows.append(cells)
    if not rows:
        return None
    num_cols = max((sum(cs for _, cs, _ in cells) for cells in rows),
                   default=0)
    num_rows = len(rows)
    if num_cols == 0:
        return None
    # grid slots: (anchor_r, anchor_c, text)
    grid: List[List[Optional[Tuple[int, int, str]]]] = \
        [[None] * num_cols for _ in range(num_rows)]
    for r, cells in enumerate(rows):
        c = 0
        for rowspan, colspan, cell_text in cells:
            while c < num_cols and grid[r][c] is not None:
                c += 1
            if c >= num_cols:
                break
            rs_end = min(r + max(rowspan, 1), num_rows)
            cs_end = min(c + max(colspan, 1), num_cols)
            for rr in range(r, rs_end):
                for cc in range(c, cs_end):
                    grid[rr][cc] = (r, c, cell_text)
            c += max(colspan, 1)
    out = []
    for r in range(num_rows):
        for c in range(num_cols):
            slot = grid[r][c]
            if slot is None:
                out.append(OTSL_ECEL)
                continue
            anchor_r, anchor_c, cell_text = slot
            if anchor_r == r and anchor_c == c:
                if cell_text:
                    out.append(OTSL_FCEL + cell_text)
                else:
                    out.append(OTSL_ECEL)
            elif anchor_r == r:
                out.append(OTSL_LCEL)
            elif anchor_c == c:
                out.append(OTSL_UCEL)
            else:
                out.append(OTSL_XCEL)
        out.append(OTSL_NL)
    return "".join(out)
