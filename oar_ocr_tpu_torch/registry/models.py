"""Model registry + asset resolution.

Re-expresses the reference's auto-download subsystem (oar-ocr-core/src/
core/download/mod.rs:1-638 — ModelScope download with SHA-256 verification
into $OAR_HOME; static 98-entry registry in registry.rs:22ff) for the TPU
build: the registry points at **converted-weight artifacts** (safetensors
/ orbax checkpoints of the flax models plus their dictionaries) rather
than ONNX files. Download is off unless OAR_TPU_ALLOW_DOWNLOAD=1;
resolution covers explicit paths, $OAR_TPU_HOME cache hits, and registry
metadata, raising a structured error when an asset is genuinely absent.

The port's copy of ``oar_ocr_tpu/registry/models.py`` (:1-323), line for
line but for this paragraph and three rewordings of how downloading is
switched on (the sentence above, the comment above ``MODELSCOPE_REPO``
and ``fetch_upstream``'s message). ``tests/test_torch_registry.py``
holds it to the original.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from dataclasses import dataclass
from typing import Dict, Optional

from ..errors import DownloadError, ModelLoadError
from .upstream import UPSTREAM_ARTIFACTS

OAR_TPU_HOME = os.environ.get(
    "OAR_TPU_HOME", os.path.join(os.path.expanduser("~"), ".oar_ocr_tpu"))


@dataclass(frozen=True)
class ModelEntry:
    """One registry entry (download/registry.rs Entry analog). ``source``
    names the upstream artifact this converted checkpoint derives from;
    its expected SHA-256/size live in upstream.UPSTREAM_ARTIFACTS and are
    verified by tools/convert_weights.py before conversion."""

    name: str
    task: str
    filename: str
    sha256: Optional[str] = None
    charset: Optional[str] = None       # companion dictionary/tokenizer
    source: Optional[str] = None        # upstream artifact (registry.rs)
    notes: str = ""


def _e(name: str, task: str, *, charset: Optional[str] = None,
       source: Optional[str] = None, notes: str = "") -> ModelEntry:
    return ModelEntry(name, task, f"{name}.safetensors", charset=charset,
                      source=source or f"{name}.onnx", notes=notes)


# Multilingual PP-OCR mobile recognizers (registry.rs lineup). v5 models
# pair with the shipped ppocrv5_* dictionaries; v3/v4 dictionaries ship
# inside the upstream model dirs and resolve via asset_path at load.
_V5_LANGS = {"arabic": "ppocrv5_arabic_dict.txt",
             "cyrillic": "ppocrv5_cyrillic_dict.txt",
             "devanagari": "ppocrv5_devanagari_dict.txt",
             "el": "ppocrv5_el_dict.txt", "en": "ppocrv5_en_dict.txt",
             "eslav": "ppocrv5_eslav_dict.txt",
             "korean": "ppocrv5_korean_dict.txt",
             "latin": "ppocrv5_latin_dict.txt", "ta": "ppocrv5_ta_dict.txt",
             "te": "ppocrv5_te_dict.txt", "th": "ppocrv5_th_dict.txt"}
_V3_LANGS = ("arabic", "chinese_cht", "cyrillic", "devanagari", "en",
             "japan", "ka", "korean", "latin", "ta", "te")

MODEL_REGISTRY: Dict[str, ModelEntry] = {e.name: e for e in [
    # ---- text detection ----
    _e("pp-ocrv4_mobile_det", "text_detection"),
    _e("pp-ocrv4_server_det", "text_detection"),
    _e("pp-ocrv5_mobile_det", "text_detection"),
    _e("pp-ocrv5_server_det", "text_detection"),
    _e("pp-ocrv6_tiny_det", "text_detection"),
    _e("pp-ocrv6_small_det", "text_detection"),
    _e("pp-ocrv6_medium_det", "text_detection"),
    _e("pp-ocrv4_mobile_seal_det", "seal_text_detection"),
    _e("pp-ocrv4_server_seal_det", "seal_text_detection"),
    # ---- text recognition: core ----
    _e("pp-ocrv3_mobile_rec", "text_recognition",
       charset="ppocr_keys_v1.txt"),
    _e("pp-ocrv4_mobile_rec", "text_recognition",
       charset="ppocr_keys_v1.txt"),
    _e("pp-ocrv4_server_rec", "text_recognition",
       charset="ppocr_keys_v1.txt"),
    _e("pp-ocrv4_server_rec_doc", "text_recognition",
       charset="ppocrv4_doc_dict.txt"),
    _e("pp-ocrv5_mobile_rec", "text_recognition",
       charset="ppocrv5_dict.txt"),
    _e("pp-ocrv5_server_rec", "text_recognition",
       charset="ppocrv5_dict.txt"),
    _e("pp-ocrv6_tiny_rec", "text_recognition",
       charset="ppocrv6_tiny_dict.txt"),
    _e("pp-ocrv6_small_rec", "text_recognition",
       charset="ppocrv6_dict.txt"),
    _e("pp-ocrv6_medium_rec", "text_recognition",
       charset="ppocrv6_dict.txt"),
    _e("ch_repsvtr_rec", "text_recognition", charset="ppocr_keys_v1.txt"),
    _e("ch_svtrv2_rec", "text_recognition", charset="ppocr_keys_v1.txt"),
    _e("en_pp-ocrv4_mobile_rec", "text_recognition"),
    # ---- text recognition: multilingual ----
    *[_e(f"{lang}_pp-ocrv5_mobile_rec", "text_recognition", charset=dct)
      for lang, dct in _V5_LANGS.items()],
    *[_e(f"{lang}_pp-ocrv3_mobile_rec", "text_recognition")
      for lang in _V3_LANGS],
    # ---- classification / rectification ----
    _e("pp-lcnet_x1_0_doc_ori", "document_orientation"),
    _e("pp-lcnet_x0_25_textline_ori", "textline_orientation"),
    _e("p2o_pp-lcnet_x0_25_textline_ori", "textline_orientation"),
    _e("pp-lcnet_x1_0_textline_ori", "textline_orientation"),
    _e("pp-lcnet_x1_0_table_cls", "table_classification"),
    _e("uvdoc", "document_rectification"),
    # ---- layout detection (one per domain/layout.py variant) ----
    *[_e(v, "layout_detection")
      for v in ("picodet_layout_1x", "picodet_layout_1x_table",
                "picodet-s_layout_3cls", "picodet-l_layout_3cls",
                "picodet-s_layout_17cls", "picodet-l_layout_17cls",
                "rt-detr-h_layout_3cls", "rt-detr-h_layout_17cls",
                "pp-docblocklayout", "pp-doclayout-s", "pp-doclayout-m",
                "pp-doclayout-l", "pp-doclayout_plus-l", "pp-doclayoutv2",
                "pp-doclayoutv3")],
    _e("rt-detr-l_wired_table_cell_det", "table_cell_detection"),
    _e("rt-detr-l_wireless_table_cell_det", "table_cell_detection"),
    # ---- table structure ----
    _e("slanet", "table_structure_recognition",
       charset="table_structure_dict_ch.txt"),
    _e("slanet_plus", "table_structure_recognition",
       charset="table_structure_dict_ch.txt"),
    _e("slanet_plus_v2", "table_structure_recognition",
       charset="table_structure_dict_ch.txt"),
    _e("slanext_wired", "table_structure_recognition",
       charset="table_structure_dict_ch.txt"),
    _e("slanext_wireless", "table_structure_recognition",
       charset="table_structure_dict_ch.txt"),
    # ---- formulas ----
    _e("pp-formulanet-s", "formula_recognition",
       charset="pp-formulanet-tokenizer.json"),
    _e("pp-formulanet-l", "formula_recognition",
       charset="pp-formulanet-tokenizer.json"),
    _e("pp-formulanet_plus-s", "formula_recognition",
       charset="pp-formulanet-tokenizer.json"),
    _e("pp-formulanet_plus-m", "formula_recognition",
       charset="pp-formulanet-tokenizer.json"),
    _e("pp-formulanet_plus-l", "formula_recognition",
       charset="pp-formulanet-tokenizer.json"),
    _e("unimernet", "formula_recognition",
       charset="unimernet_tokenizer.json"),
    _e("latex_ocr_rec", "formula_recognition",
       charset="unimernet_tokenizer.json"),
    # ---- VLM families (HF checkpoints; charset = HF tokenizer.json) ----
    ModelEntry("paddleocr-vl-0.9b", "vlm", "paddleocr_vl.safetensors",
               charset="paddleocr_vl_tokenizer.json"),
    ModelEntry("paddleocr-vl-1.5", "vlm", "paddleocr_vl_15.safetensors",
               charset="paddleocr_vl_tokenizer.json"),
    ModelEntry("paddleocr-vl-1.6", "vlm", "paddleocr_vl_16.safetensors",
               charset="paddleocr_vl_tokenizer.json"),
    ModelEntry("hunyuanocr-1.5", "vlm", "hunyuanocr_15.safetensors",
               charset="hunyuan_tokenizer.json"),
    ModelEntry("hunyuanocr-1.0", "vlm", "hunyuanocr_10.safetensors",
               charset="hunyuan_tokenizer.json"),
    ModelEntry("glm-ocr", "vlm", "glmocr.safetensors",
               charset="glm_tokenizer.json"),
    ModelEntry("mineru-2.5", "vlm", "mineru25.safetensors",
               charset="qwen2_tokenizer.json"),
    ModelEntry("mineru-2.5-pro", "vlm", "mineru25_pro.safetensors",
               charset="qwen2_tokenizer.json"),
    ModelEntry("mineru-diffusion-v1", "vlm", "mineru_diffusion.safetensors",
               charset="qwen2_tokenizer.json"),
    ModelEntry("hpd-parsing-1b", "vlm", "hpd_parsing.safetensors",
               charset="internlm_tokenizer.json"),
    ModelEntry("ovisocr2-0.8b", "vlm", "ovisocr2.safetensors",
               charset="qwen3_tokenizer.json"),
    ModelEntry("monkeyocrv2-s", "vlm", "monkeyocrv2_s.safetensors",
               charset="qwen2_tokenizer.json"),
    ModelEntry("monkeyocrv2-b", "vlm", "monkeyocrv2_b.safetensors",
               charset="qwen2_tokenizer.json"),
]}

# Companion assets shipped as first-class registry entries upstream
# (dictionaries + tokenizers, registry.rs) — resolvable via asset_path.
ASSET_REGISTRY = tuple(
    n for n in UPSTREAM_ARTIFACTS if n.endswith((".txt", ".json")))


def upstream_provenance(entry: ModelEntry):
    """(sha256, size) of the upstream artifact this entry converts from,
    or None for HF-hub families outside registry.rs."""
    if entry.source is None:
        return None
    return UPSTREAM_ARTIFACTS.get(entry.source)


def asset_path(filename: str) -> Optional[str]:
    """Locate a companion asset (dictionary / tokenizer file): in-repo
    ``assets/`` first, then the $OAR_TPU_HOME/assets cache. Returns None
    when absent (callers fall back to documented defaults)."""

    repo_assets = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "assets")
    for base in (repo_assets, os.path.join(OAR_TPU_HOME, "assets")):
        p = os.path.join(base, filename)
        if os.path.exists(p):
            return p
    return None


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


# --------------------------- network fetch ---------------------------
# The reference auto-downloads upstream artifacts from its ModelScope
# mirror with 3 retries and SHA-256 verification
# (oar-ocr-core/src/core/download/mod.rs:59-64, :251-255 URL scheme).
# The same flow exists here behind OAR_TPU_ALLOW_DOWNLOAD=1 — it is
# opt-in, so nothing reaches the network unasked; with it the framework
# fetches upstream checkpoints for tools/convert_weights.py itself.

MODELSCOPE_REPO = "greatv/oar-ocr"
DEFAULT_REVISION = "master"
DOWNLOAD_RETRIES = 3
CONNECT_TIMEOUT_SECS = 30


def artifact_url(filename: str, *, repo: str = MODELSCOPE_REPO,
                 revision: str = DEFAULT_REVISION) -> str:
    """download/mod.rs:251-255 URL scheme."""
    from urllib.parse import quote

    return (f"https://www.modelscope.cn/api/v1/models/{repo}/repo"
            f"?Revision={revision}&FilePath={quote(filename)}")


def downloads_enabled() -> bool:
    return os.environ.get("OAR_TPU_ALLOW_DOWNLOAD", "") not in ("", "0")


def fetch_upstream(filename: str, *, target_dir: Optional[str] = None,
                   retries: int = DOWNLOAD_RETRIES,
                   opener=None) -> str:
    """Fetch one upstream artifact into the cache: GET → .part file →
    SHA-256 verify against UPSTREAM_ARTIFACTS → atomic rename, with
    ``retries`` attempts (download/mod.rs:59 DOWNLOAD_RETRIES=3,
    download_attempt :272-340). ``opener`` is injectable for tests."""

    if not downloads_enabled():
        raise DownloadError(
            "downloads disabled (set OAR_TPU_ALLOW_DOWNLOAD=1 to fetch "
            "upstream artifacts over the network)",
            artifact=filename)
    target_dir = target_dir or os.path.join(OAR_TPU_HOME, "upstream")
    os.makedirs(target_dir, exist_ok=True)
    target = os.path.join(target_dir, filename)
    expect = UPSTREAM_ARTIFACTS.get(filename)
    if os.path.exists(target):
        if expect is None or sha256_file(target) == expect[0]:
            return target
        os.remove(target)          # corrupt cache entry: refetch

    if opener is None:
        from urllib.request import urlopen

        def opener(url):
            return urlopen(url, timeout=CONNECT_TIMEOUT_SECS)

    url = artifact_url(filename)
    last_err: Optional[Exception] = None
    for attempt in range(retries):
        part = target + ".part"
        try:
            with opener(url) as resp, open(part, "wb") as f:
                while True:
                    chunk = resp.read(1 << 16)
                    if not chunk:
                        break
                    f.write(chunk)
            if expect is not None:
                actual = sha256_file(part)
                if actual != expect[0]:
                    raise DownloadError("checksum mismatch",
                                        artifact=filename,
                                        expected=expect[0], actual=actual)
                if os.path.getsize(part) != expect[1]:
                    raise DownloadError("size mismatch", artifact=filename,
                                        expected=expect[1],
                                        actual=os.path.getsize(part))
            os.replace(part, target)
            return target
        except Exception as e:          # noqa: BLE001 — retry ladder
            last_err = e
            if os.path.exists(part):
                os.remove(part)
    raise DownloadError(
        f"download failed after {retries} attempts", artifact=filename,
        url=url) from last_err


def resolve_model_path(name_or_path: str, *, verify: bool = True) -> str:
    """Resolve a model asset: explicit path → as-is; registry name →
    $OAR_TPU_HOME cache (download/mod.rs resolve_path semantics; the
    network half lives in :func:`fetch_upstream` — converted weights are
    produced locally by tools/convert_weights.py from fetched upstream
    artifacts, so a cache miss points there)."""

    if os.path.exists(name_or_path):
        return name_or_path
    entry = MODEL_REGISTRY.get(name_or_path)
    if entry is None:
        raise ModelLoadError("unknown model and path does not exist",
                             model=name_or_path)
    cached = os.path.join(OAR_TPU_HOME, "models", entry.filename)
    if os.path.exists(cached):
        if verify and entry.sha256:
            actual = sha256_file(cached)
            if actual != entry.sha256:
                raise DownloadError("checksum mismatch", model=entry.name,
                                    expected=entry.sha256, actual=actual)
        return cached
    hint = ("run tools/convert_weights.py (with OAR_TPU_ALLOW_DOWNLOAD=1 "
            "to auto-fetch the upstream artifact) or place the converted "
            "weights at the cache path")
    raise DownloadError("model asset not cached; " + hint,
                        model=entry.name, cache_path=cached)
