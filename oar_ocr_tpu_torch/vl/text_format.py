"""VL output text formatting + markdown export.

Port of the reference's VL text normalizers
(oar-ocr-vl/src/utils/text.rs:1-330) and the two markdown exporters
(oar-ocr-vl/src/utils.rs:474-765): ``to_markdown`` (per-element-type
formatting with format_formula/format_table/format_text) and
``to_markdown_openocr`` (PaddleX ``PaddleOCRVLResult._to_markdown``
compatibility, label-driven with pretty-HTML mode).

Pure host string work — no device involvement.
"""

from __future__ import annotations

import re
from typing import Iterable, List, Optional, Sequence

from ..domain.structure import LayoutElement, LayoutElementType

# Shared regex patterns (utils/text.rs:5-17)
_UNDERSCORE_RE = re.compile(r"_{4,}")
_DOTS_RE = re.compile(r"\.{4,}")
_LATEX_BRACKETS_RE = re.compile(
    r"\\(big|Big|bigg|Bigg|bigl|bigr|Bigl|Bigr|biggr|biggl|Biggl|Biggr)"
    r"\{(\\?[{}\[\]()|])\}")
_TABLE_TAG_RE = re.compile(r"</?(table|tr|th|td|thead|tbody|tfoot)[^>]*>")
_TAG_NEWLINES_RE = re.compile(r">\s*\n+\s*")


def clean_special_tokens(text: str) -> str:
    """utils/text.rs:20 — strip decoder sentinels."""
    return (text.replace("-<|sn|>", "").replace("<|sn|>", " ")
            .replace("<|unk|>", "").replace("￿", ""))


def process_text(text: str) -> str:
    """Collapse OCR artifact runs (utils/text.rs:28): 4+ underscores →
    ``___``, 4+ dots → ``...``, then trim."""
    text = _UNDERSCORE_RE.sub("___", text)
    text = _DOTS_RE.sub("...", text)
    return text.strip()


def fix_latex_brackets(text: str) -> str:
    r"""``\big{(}`` → ``\big(`` etc. (utils/text.rs:99)."""
    return _LATEX_BRACKETS_RE.sub(r"\\\1\2", text)


def format_formula(text: str) -> str:
    r"""Normalize a formula and wrap in display math (utils/text.rs:36):
    clean sentinels, ``\upmu``→``\mu``, drop existing delimiters, turn
    newlines into LaTeX line breaks, fix bracket sizing, ``$$…$$``."""
    result = clean_special_tokens(text)
    result = result.replace(r"\upmu", r"\mu")
    for delim in ("\\[", "\\]", "\\(", "\\)"):
        result = result.replace(delim, "")
    result = result.strip().strip("$")
    result = result.replace("\n", "\\\\\n")
    result = fix_latex_brackets(result)
    return f"$${result.strip()}$$"


def format_table(text: str) -> str:
    """Table-HTML cleanup (utils/text.rs:56): common OCR attribute
    glitches, sentinels, LaTeX delimiters → $, newline-after-tag
    collapse. Never run the text normalizer on table markup."""
    result = text.replace("<tdcolspan=", "<td colspan=")
    result = result.replace("<tdrowspan=", "<td rowspan=")
    result = result.replace('"colspan=', '" colspan=')
    result = clean_special_tokens(result)
    result = result.replace("\\(", "$").replace("\\)", "$")
    result = result.replace("\\[", "$$").replace("\\]", "$$")
    return _TAG_NEWLINES_RE.sub(">", result)


def format_text(text: str) -> str:
    """Regular-text normalization (utils/text.rs:76)."""
    result = clean_special_tokens(text)
    if "\\(" in result and "\\)" in result:
        result = result.replace("\\(", " $ ").replace("\\)", " $ ")
    if "\\[" in result and "\\]" in result:
        result = result.replace("\\[", " $$ ").replace("\\]", " $$ ")
    result = result.replace(r"$\bullet$", "•")
    if "<table>" in result:
        result = _TABLE_TAG_RE.sub("", result)
    result = tighten_inline_dollar_math(result)
    result = collapse_consecutive_spaces(result)
    result = remove_space_before_punctuation(result)
    return process_text(result)


def collapse_consecutive_spaces(text: str) -> str:
    """utils/text.rs:116 — runs of ' ' → one (other whitespace kept)."""
    out: List[str] = []
    prev_space = False
    for ch in text:
        if ch == " ":
            if prev_space:
                continue
            prev_space = True
        else:
            prev_space = False
        out.append(ch)
    return "".join(out)


def tighten_inline_dollar_math(text: str) -> str:
    """Trim whitespace just inside single ``$…$`` spans, leaving
    ``$$…$$`` untouched; unmatched ``$`` (currency) kept verbatim
    (utils/text.rs:134-188)."""
    chars = list(text)
    n = len(chars)
    out: List[str] = []
    i = 0
    while i < n:
        c = chars[i]
        if c != "$":
            out.append(c)
            i += 1
            continue
        prev_d = i > 0 and chars[i - 1] == "$"
        next_d = i + 1 < n and chars[i + 1] == "$"
        if prev_d or next_d:
            out.append("$")
            i += 1
            continue
        close_idx = None
        j = i + 1
        while j < n:
            if chars[j] == "$":
                pd = chars[j - 1] == "$"
                nd = j + 1 < n and chars[j + 1] == "$"
                if pd or nd:
                    j += 1
                    continue
                close_idx = j
                break
            j += 1
        if close_idx is not None:
            inner = "".join(chars[i + 1:close_idx]).strip()
            out.append(f"${inner}$")
            i = close_idx + 1
        else:
            out.append("$")
            i += 1
    return "".join(out)


def remove_space_before_punctuation(text: str) -> str:
    """utils/text.rs:190 — drop a space directly before ,.;:!?)"""
    out: List[str] = []
    n = len(text)
    for i, ch in enumerate(text):
        if ch == " " and i + 1 < n and text[i + 1] in ",.;:!?)":
            continue
        out.append(ch)
    return "".join(out)


# --------------- repetition truncation (utils/text.rs:210-330) ---------------

def _find_shortest_repeating_substring(s: str) -> Optional[str]:
    """Whole-string periodicity: the shortest unit whose tiling equals
    the string (utils/text.rs:210)."""
    n = len(s)
    for i in range(1, n // 2 + 1):
        if n % i:
            continue
        unit = s[:i]
        if unit * (n // i) == s:
            return unit
    return None


def _find_repeating_suffix(s: str, min_len: int, min_repeats: int):
    """Longest suffix unit repeated ≥ min_repeats times at the tail;
    returns (prefix, unit, count) (utils/text.rs:228)."""
    n = len(s)
    for i in range(n // min_repeats, min_len - 1, -1):
        total = i * min_repeats
        if n < total:
            continue
        unit = s[n - i:]
        start = n - total
        if all(s[start + k * i:start + (k + 1) * i] == unit
               for k in range(min_repeats)):
            count = 0
            end = n
            while end >= i and s[end - i:end] == unit:
                count += 1
                end -= i
            return s[:end], unit, count
    return None


def truncate_repetitive_content(content: str, line_threshold: int = 10,
                                char_threshold: int = 10,
                                min_len: int = 10) -> str:
    """Cut decoder repetition loops (utils/text.rs:261-330). Three
    mechanisms, in order: (1) single-line >100 chars with a ≥5×-repeated
    ≥8-char suffix covering >half → keep the prefix; (2) single-line
    whole-string periodicity with ≥ char_threshold repeats → one unit;
    (3) a line repeated ≥ line_threshold times making up ≥80% of all
    lines → that line once."""
    stripped = content.strip()
    if not stripped:
        return content
    n = len(stripped)
    if "\n" not in stripped and n > 100:
        got = _find_repeating_suffix(stripped, 8, 5)
        if got is not None:
            prefix, unit, count = got
            if len(unit) * count > n // 2:
                return prefix
    if "\n" not in stripped and n > min_len:
        unit = _find_shortest_repeating_substring(stripped)
        if unit is not None and n // len(unit) >= char_threshold:
            return unit
    lines = [ln.strip() for ln in content.splitlines() if ln.strip()]
    if not lines or len(lines) < line_threshold:
        return content
    counts: dict = {}
    for ln in lines:
        counts[ln] = counts.get(ln, 0) + 1
    most_common, count = max(counts.items(), key=lambda kv: kv[1])
    if count >= line_threshold and count / len(lines) >= 0.8:
        return most_common
    return content


# ------------------- markdown export (utils.rs:474-765) -------------------

# DocParserConfig.markdown_ignore_labels default (doc_parser.rs:99-110)
DEFAULT_MARKDOWN_IGNORE_LABELS = (
    "number", "footnote", "header", "header_image", "footer",
    "footer_image", "aside_text", "formula_number")


def _remove_newlines_in_heading(text: str) -> str:
    """utils.rs:751 — CJK headings drop newlines, Latin replace with
    spaces."""
    if any("一" <= c <= "鿿" for c in text):
        return text.replace("\n", "")
    return text.replace("\n", " ")


def _format_heading(text: str, level: int) -> str:
    """utils.rs:702."""
    return f"{'#' * min(level, 6)} {process_text(_remove_newlines_in_heading(text).strip())}"


def _format_figure(text: str, index: int) -> str:
    """utils.rs:709 — pass through markdown images, link file-ish paths,
    caption everything else."""
    if text.startswith("!["):
        return text
    if (text.startswith("figures/") or text.startswith("imgs/")
            or text.startswith("data:image/")):
        return f"![Figure {index + 1}]({text})"
    return f"*Figure {index + 1}: {text}*"


def _format_list(text: str) -> str:
    """utils.rs:722 — bullet non-bulleted lines."""
    out: List[str] = []
    for line in text.splitlines():
        t = line.strip()
        if not t:
            continue
        if t.startswith("-") or t.startswith("*") or t[:1].isdigit():
            out.append(t)
        else:
            out.append(f"- {t}")
    return "\n".join(out)


def _format_code(text: str) -> str:
    """utils.rs:747."""
    return f"```\n{text.strip()}\n```"


def to_markdown(elements: Sequence[LayoutElement],
                ignore_labels: Iterable[str] = DEFAULT_MARKDOWN_IGNORE_LABELS
                ) -> str:
    """Per-element-type markdown assembly (utils.rs:474-509): headings
    for titles, format_table / format_formula / format_figure /
    format_list / format_code per type, format_text for everything else;
    blocks joined with blank lines."""
    ignore = set(ignore_labels)
    parts: List[str] = []
    for i, el in enumerate(elements):
        text = (el.text or "").strip()
        if not text:
            if el.element_type == LayoutElementType.TABLE and el.table:
                text = (el.table.html or "").strip()
            elif el.element_type.is_formula and el.formula_latex:
                text = el.formula_latex.strip()
            if not text:
                continue
        label = el.label if getattr(el, "label", None) else None
        if label is not None and label in ignore:
            continue
        t = el.element_type
        if t == LayoutElementType.DOC_TITLE:
            content = _format_heading(text, 1)
        elif t == LayoutElementType.PARAGRAPH_TITLE:
            content = _format_heading(text, 2)
        elif t == LayoutElementType.TABLE:
            content = format_table(text)
        elif t.is_formula:
            content = format_formula(text)
        elif t in (LayoutElementType.IMAGE, LayoutElementType.CHART,
                   LayoutElementType.SEAL):
            content = _format_figure(text, i)
        elif t == LayoutElementType.LIST:
            content = _format_list(text)
        elif t == LayoutElementType.ALGORITHM:
            content = _format_code(text)
        else:
            content = format_text(text)
        if content:
            parts.append(content)
    return "\n\n".join(parts).strip()


# PaddleX compile_title_pattern() (utils.rs:515-520)
_OPENOCR_TITLE_RE = re.compile(
    r"^\s*((?:[1-9][0-9]*(?:\.[1-9][0-9]*)*[.、]?"
    r"|[(（](?:[1-9][0-9]*|[一二三四五六七八九十百千万亿零壹贰叁肆伍陆柒捌玖拾]+)[)）]"
    r"|[一二三四五六七八九十百千万亿零壹贰叁肆伍陆柒捌玖拾]+[、.]?"
    r"|(?:I|II|III|IV|V|VI|VII|VIII|IX|X)(?:\.|\s)))(\s*)(.*)$")


def _openocr_format_title(text: str) -> str:
    """utils.rs:523-546 — normalize numbering spacing, heading level =
    dot count + 2."""
    title = text
    m = _OPENOCR_TITLE_RE.match(title)
    if m:
        numbering = (m.group(1) or "").strip()
        title_content = (m.group(3) or "").lstrip()
        if numbering:
            title = f"{numbering} {title_content}"
    title = title.rstrip(".")
    level = title.count(".") + 1 if "." in title else 1
    return (f"{'#' * (level + 1)} {title}"
            .replace("-\n", "").replace("\n", " "))


def _openocr_format_centered_by_html(text: str) -> str:
    """utils.rs:548."""
    content = text.replace("-\n", "").replace("\n", " ")
    return f'<div style="text-align: center;">{content}</div>\n'


def _openocr_format_table_center(html: str) -> str:
    """utils.rs:553."""
    return (html.replace(
        "<table>",
        "<table border=1 style='margin: auto; word-wrap: break-word;'>")
        .replace("<th>",
                 "<th style='text-align: center; word-wrap: break-word;'>")
        .replace("<td>",
                 "<td style='text-align: center; word-wrap: break-word;'>"))


def _openocr_format_text_block(text: str) -> str:
    """utils.rs:570."""
    return text.replace("\n\n", "\n").replace("\n", "\n\n")


def _openocr_format_content_block(text: str) -> str:
    """utils.rs:574."""
    return text.replace("-\n", "  \n").replace("\n", "  \n")


def _openocr_format_first_line(text: str, templates_lower: Sequence[str],
                               fmt, splitter: str) -> str:
    """utils.rs:578 — rewrite the first non-empty part when it equals a
    known section heading (case-insensitive)."""
    parts = text.split(splitter)
    for k, part in enumerate(parts):
        if not part.strip():
            continue
        if part.lower() in templates_lower:
            parts[k] = fmt(part)
        break
    return splitter.join(parts)


def to_markdown_openocr(
        elements: Sequence[LayoutElement],
        ignore_labels: Iterable[str] = DEFAULT_MARKDOWN_IGNORE_LABELS,
        pretty: bool = True) -> str:
    """OpenOCR/PaddleX-compatible markdown
    (utils.rs:601-700 ``to_markdown_openocr``): label-driven dispatch
    with a ``pretty`` HTML mode for captions + tables; falls back to the
    element-type heuristic when the label is unknown."""
    ignore = set(ignore_labels)
    parts: List[str] = []
    for el in elements:
        label = getattr(el, "label", None) or ""
        if label in ignore:
            continue
        content = el.text or ""
        if not content:
            if el.element_type == LayoutElementType.TABLE and el.table:
                content = el.table.html or ""
            elif el.element_type.is_formula and el.formula_latex:
                content = el.formula_latex or ""

        if label in ("paragraph_title", "abstract_title",
                     "reference_title", "content_title"):
            formatted = _openocr_format_title(content)
        elif label == "doc_title":
            formatted = (f"# {content}".replace("-\n", "")
                         .replace("\n", " "))
        elif label in ("table_title", "figure_title", "chart_title"):
            formatted = (_openocr_format_centered_by_html(content)
                         if pretty else content)
        elif label in ("text", "ocr", "vertical_text",
                       "reference_content"):
            formatted = _openocr_format_text_block(content)
        elif label == "abstract":
            formatted = _openocr_format_first_line(
                content, ("摘要", "abstract"), lambda l: f"## {l}\n", " ")
        elif label == "reference":
            formatted = _openocr_format_first_line(
                content, ("参考文献", "references"), lambda l: f"## {l}", "\n")
        elif label == "content":
            formatted = _openocr_format_content_block(content)
        elif label == "table":
            if pretty:
                formatted = f"\n{_openocr_format_table_center(content)}"
            else:
                formatted = (f"\n{content}"
                             .replace("<html>", "").replace("</html>", "")
                             .replace("<body>", "").replace("</body>", ""))
        elif label in ("formula", "display_formula", "inline_formula"):
            formatted = content
        elif label == "algorithm":
            formatted = content.strip("\n")
        else:
            t = el.element_type
            if t == LayoutElementType.PARAGRAPH_TITLE:
                formatted = _openocr_format_title(content)
            elif t == LayoutElementType.DOC_TITLE:
                formatted = (f"# {content}".replace("-\n", "")
                             .replace("\n", " "))
            elif t == LayoutElementType.TABLE:
                formatted = (f"\n{_openocr_format_table_center(content)}"
                             if pretty else content)
            else:
                formatted = content
        parts.append(formatted)
    return "\n\n".join(parts)
