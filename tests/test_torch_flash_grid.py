"""K2's float32 launch rule (``ops/flash_attention.fma_grid``) on its
arithmetic, against values worked by hand for the H100's 132 SMs, and
the instance table it computes with against the CUDA source.

The tiles grid launches a CTA per (b·h, query tile) and runs
``ceil(CTAs / slots)`` waves of a tile's ``ceil(Tk / BK)`` key blocks; the
stream grid (float32 D = 64, no valid_len, not causal; 32-key blocks,
three CTAs an SM, so 396 slots) gives each of ``min(slots, units)`` CTAs
``ceil(units / CTAs)`` of the (b·h, tile, key block) units and one block
more for its cut tiles. The rule takes the stream grid only where an SM
computes fewer (query, key) pairs (blocks × BK × BQ × CTAs an SM). No
card is needed.
"""

import pathlib
import re

import pytest
import torch

from oar_ocr_tpu_torch.errors import UnsupportedError
from oar_ocr_tpu_torch.ops import flash_attention as fa

SMS = 132          # the H100 SXM's SMs
SOURCE = (pathlib.Path(fa.__file__).resolve().parents[1] / "csrc"
          / "flash_attention.cu")


# HPD's InternViT: 16 heads × 1025 tokens a tile, B tiles an image;
# 17 query tiles, 17 key blocks of 64 (the last holding one row, one key)
# or 33 of 32 (the stream instance's)
@pytest.mark.parametrize("b,tiles_ctas,tiles_blocks,stream_blocks", [
    (1, 272, 2 * 17, 23 + 1),      # 8976 units / 396 = 22.7
    (3, 816, 4 * 17, 68 + 1),      # 26928 / 396 = 68
    (4, 1088, 5 * 17, 91 + 1),     # 35904 / 396 = 90.7
    (5, 1360, 6 * 17, 114 + 1),    # 44880 / 396 = 113.3
])
def test_hpd_tiles_take_the_stream_grid(b, tiles_ctas, tiles_blocks,
                                        stream_blocks):
    masked = fa.fma_grid(16 * b, 1025, 1025, 64, False, True, SMS)
    assert masked == fa.FmaGrid("tiles", tiles_ctas, 264, tiles_blocks,
                                tiles_blocks * 64 * 64 * 2)
    # every image count overshoots a whole wave of 264 slots by 8 CTAs
    assert masked.ctas % 264 == 8 * b
    grid = fa.fma_grid(16 * b, 1025, 1025, 64, False, False, SMS)
    assert grid == fa.FmaGrid("stream", 396, 396, stream_blocks,
                              stream_blocks * 32 * 64 * 3)
    assert grid.waves == 1.0
    assert grid.sm_pairs < masked.sm_pairs


@pytest.mark.parametrize("bh,tq,tk,d,causal,masked,want", [
    # the family towers at 4920 tokens (valid_len given): 77 tiles a head
    (16, 4920, 4920, 64, False, True, ("tiles", 1232, 5 * 77)),
    (32, 4920, 4920, 64, False, True, ("tiles", 2464, 10 * 77)),
    # MinerU's page at D = 80 (56-key blocks), and D = 80 with valid_len
    # (two 448×448 crops' shape; no path launches it)
    (16, 6256, 6256, 80, False, False, ("tiles", 1568, 6 * 112)),
    (32, 1024, 1024, 80, False, True, ("tiles", 512, 2 * 19)),
    # GLM-OCR at D = 128: 49 tiles of 128 rows, two CTAs a tile, one an SM
    (12, 6256, 6256, 128, False, False, ("tiles", 1176, 9 * 49)),
    # causal at D = 64 and 128
    (16, 1024, 1024, 64, True, False, ("tiles", 256, 16)),
    (16, 1024, 1024, 128, True, False, ("tiles", 256, 2 * 8)),
    # HunyuanOCR's tower at D = 72: no stream form
    (16, 4800, 4800, 72, False, False, ("tiles", 1200, 5 * 75)),
    # 264 CTAs fill one wave of 11 blocks (1408 keys an SM); the stream
    # grid's 5808 units run 15 + 1 blocks of 32 keys, 3 CTAs an SM: 1536
    (24, 704, 704, 64, False, False, ("tiles", 264, 11)),
])
def test_other_shapes_keep_the_tiles_grid(bh, tq, tk, d, causal, masked,
                                          want):
    kind, ctas, blocks = want
    t = fa.FMA_TILINGS[d]
    slots = SMS * t.ctas_per_sm
    assert fa.fma_grid(bh, tq, tk, d, causal, masked, SMS) == \
        fa.FmaGrid(kind, ctas, slots, blocks,
                   blocks * t.bk * t.bq * t.ctas_per_sm)


# MinerU's tower at D = 80: a 448×448 crop is (1, 16, 1024, 80), the
# page (1, 16, 6256, 80); each tower call encodes one image, unmasked.
# FmaD80 takes 64 query rows and 56-key blocks, two CTAs an SM (264
# slots); 1024 = 18·56 + 16 keys, 6256 = 111·56 + 40. D = 80 has no
# stream grid: every shape, masked, causal or not, takes the tiles grid.
@pytest.mark.parametrize("bh,tq,tk,causal,masked,ctas,blocks", [
    (16, 1024, 1024, False, False, 256, 19),     # the crop: 0.97 of a wave
    (16, 1024, 1024, False, True, 256, 19),
    (16, 1024, 1024, True, False, 256, 19),
    (16, 6256, 6256, False, True, 1568, 6 * 112),  # 5.94 waves
    (16, 6256, 6256, True, False, 1568, 6 * 112),
    (32, 1024, 1024, True, False, 512, 2 * 19),
    (2, 1024, 1024, False, False, 32, 19),
    (1, 1, 1, False, False, 1, 1),
])
def test_mineru_d80_takes_the_tiles_grid(bh, tq, tk, causal, masked, ctas,
                                         blocks):
    grid = fa.fma_grid(bh, tq, tk, 80, causal, masked, SMS)
    assert grid == fa.FmaGrid("tiles", ctas, 264, blocks,
                              blocks * 56 * 64 * 2)
    assert 80 not in fa.STREAM_TILINGS


@pytest.mark.parametrize("bh,tq,tk,units", [
    (16, 1024, 1024, 16 * 16 * 19),     # the crop: 19 blocks, the last 16 keys
    (16, 6256, 6256, 16 * 98 * 112),    # the page: 98 tiles, 112 blocks
])
def test_units_of_the_d80_tiling(bh, tq, tk, units):
    """The (b·h, query tile, key block) units of FmaD80: its CTAs times
    the blocks each runs."""
    assert fa._units(fa.FMA_TILINGS[80], bh, tq, tk) == units
    grid = fa.fma_grid(bh, tq, tk, 80, False, False, SMS)
    assert units == grid.ctas * -(-tk // 56)


def test_small_grids_spread_over_every_slot():
    """6 heads of 1025 tokens: 102 tiles, 3366 units of 32 keys; 396 CTAs
    of 9 blocks, each tile cut over three to five CTAs (960 keys an SM, 64
    rows a CTA) against one wave of 17 blocks of 64 (2176)."""
    assert fa.fma_grid(6, 1025, 1025, 64, False, False, SMS) == \
        fa.FmaGrid("stream", 396, 396, 10, 960 * 64)
    # fewer units than slots: a CTA a unit
    assert fa.fma_grid(2, 65, 65, 64, False, False, SMS) == \
        fa.FmaGrid("stream", 12, 396, 2, 192 * 64)
    # one SM: 4 tiles in two waves of 2 blocks (512 keys) against 3 CTAs
    # of 4 units and 1 (480)
    assert fa.fma_grid(2, 65, 65, 64, False, False, 1) == \
        fa.FmaGrid("stream", 3, 3, 5, 480 * 64)
    assert fa.fma_grid(0, 65, 65, 64, False, False, SMS).kind == "tiles"


@pytest.mark.parametrize("kind,dtype,d,causal", [
    ("stream", torch.float32, 80, False),
    ("stream", torch.float32, 80, True),
    ("stream", torch.float32, 72, False),
    ("stream", torch.float32, 128, False),
    ("stream", torch.float32, 64, True),
    ("stream", torch.bfloat16, 64, False),
    ("waves", torch.float32, 64, False),
])
def test_a_grid_the_kernel_does_not_have_raises(kind, dtype, d, causal):
    with pytest.raises(UnsupportedError):
        fa.check_grid(fa.FmaGrid(kind, 4, 4, 0, 0), dtype, d, causal, 100)
    fa.check_grid(fa.FmaGrid("tiles", 4, 4, 0, 0), dtype, d, causal, 100)


@pytest.mark.parametrize("ctas,ok", [(0, False), (1, True), (792, True),
                                     (793, False)])
def test_the_stream_grid_has_a_unit_a_cta(ctas, ok):
    """(3, 2, 200, 1025) at D = 64: 6 heads × 4 tiles × 33 blocks of 32
    keys = 792 units, so 1-792 CTAs."""
    units = fa._units(fa.STREAM_TILINGS[64], 6, 200, 1025)
    assert units == 792
    grid = fa.FmaGrid("stream", ctas, 396, 0, 0)
    if ok:
        fa.check_grid(grid, torch.float32, 64, False, units)
    else:
        with pytest.raises(UnsupportedError):
            fa.check_grid(grid, torch.float32, 64, False, units)


def test_instance_table_is_the_sources():
    """FMA_TILINGS and STREAM_TILINGS (the rule's arithmetic) declare each
    float32 instance as ``flash_attention.cu`` does: query rows, keys a
    block, threads (rows / 4 × 8 lanes for Fma), CTAs an SM and a tile;
    the C entry names a tiles instance of each head dim and a stream one
    of D = 64, in that order; and the stream workspace is two slots of
    BQ·(D + 2) floats a CTA and a count."""
    src = SOURCE.read_text()
    found = {}
    for name, d, tm, g, bq, bk, ctas in re.findall(
            r"using (FmaD(\d+)S?) = Fma<\2, (\d+), (\d+), (\d+), (\d+), 2"
            r"(?:, (\d+))?>;", src):
        found[name] = (int(bq), int(bk), int(bq) // int(tm) * int(g),
                       int(ctas or 2), 1)
    (d, bq, bk), = re.findall(
        r"using FmaD(\d+) = FmaSplit<\1, (\d+), (\d+)>;", src)
    found[f"FmaD{d}"] = (int(bq), int(bk), 2 * int(bq), 1, 2)
    tables = list(fa.FMA_TILINGS.values()) + list(fa.STREAM_TILINGS.values())
    assert found == {t.name: (t.bq, t.bk, t.threads, t.ctas_per_sm, t.split)
                     for t in tables}
    names = re.search(r"names\[\] = \{([^}]*)\}", src).group(1)
    assert sorted(re.findall(r'"([^"]+)"', names)) == sorted(
        [f"{t.name} tiles" for t in fa.FMA_TILINGS.values()]
        + [f"{t.name} stream" for t in fa.STREAM_TILINGS.values()])
    assert fa.stream_workspace_floats(64, 396) == 2 * 396 * 64 * 66 + 396


def test_check_instances_holds_the_library_to_the_table():
    """Phase 2's check of ``oar_flash_fma_info``: an instance must fit the
    CTAs it declares and declare the rule's tiling; every tiling needs its
    instance."""
    good = [{"name": f"{t.name} {g}", "d": d, "bq": t.bq, "bk": t.bk,
             "threads": t.threads, "smem_bytes": 1, "split": t.split,
             "ctas_per_sm": t.ctas_per_sm, "declared_ctas": t.ctas_per_sm,
             "rc": 0}
            for g, table in (("tiles", fa.FMA_TILINGS),
                             ("stream", fa.STREAM_TILINGS))
            for d, t in table.items()]
    fa.check_instances(good)
    for bad in ({"ctas_per_sm": 1}, {"bq": 80}, {"rc": 1},
                {"declared_ctas": 1, "ctas_per_sm": 1}):
        case = [dict(f) for f in good]
        case[-1].update(bad)
        with pytest.raises(AssertionError):
            fa.check_instances(case)
    with pytest.raises(AssertionError):
        fa.check_instances(good[:-1])                 # no stream instance
