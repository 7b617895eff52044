"""The port's geometries: TPUTile against the JAX package's TileGeometry,
and H100Sector on hand-worked cases."""

import numpy as np
import pytest

from repro.core.tiles import TileGeometry, block_to_2d as ref_block_to_2d
from repro.core.tiles import words_per_sector as ref_words_per_sector
from repro_torch.core.tiles import (
    H100Sector,
    TPUTile,
    block_to_2d,
    make_geometry,
)


def _shapes(seed):
    rng = np.random.default_rng(seed)
    return [
        (int(rng.integers(1, 700)),),
        (int(rng.integers(1, 70)), int(rng.integers(1, 400))),
        (int(rng.integers(1, 5)), int(rng.integers(1, 40)), int(rng.integers(1, 300))),
    ]


@pytest.mark.parametrize("itemsize", [1, 2, 4, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tpu_tile_matches_reference(itemsize, seed):
    rng = np.random.default_rng(100 + seed)
    for shape in _shapes(seed):
        want = TileGeometry(shape, itemsize)
        got = TPUTile(shape, itemsize)
        assert got.shape2d == want.shape2d
        assert got.words_per_sector == ref_words_per_sector(itemsize)
        for attr in ("sublanes", "lane_tiles", "sublane_tiles", "n_sectors",
                     "sector_bytes", "word_bytes"):
            assert getattr(got, attr) == getattr(want, attr), attr
        rows, cols = want.shape2d
        for _ in range(20):
            r0, r1 = sorted(int(x) for x in rng.integers(-3, rows + 4, 2))
            c0, c1 = sorted(int(x) for x in rng.integers(-3, cols + 4, 2))
            for g, w in zip(got.slice_to_touch_arrays(r0, r1, c0, c1),
                            want.slice_to_touch_arrays(r0, r1, c0, c1)):
                np.testing.assert_array_equal(g, w)
            assert got.is_aligned_slice(r0, r1, c0, c1) == \
                want.is_aligned_slice(r0, r1, c0, c1)
            n = rows * cols
            s0, s1 = sorted(int(x) for x in rng.integers(-3, n + 4, 2))
            for g, w in zip(got.run_to_touch_arrays(s0, s1),
                            want.run_to_touch_arrays(s0, s1)):
                np.testing.assert_array_equal(g, w)
            r, c = int(rng.integers(0, rows)), int(rng.integers(0, cols))
            assert got.sector_tag(r, c) == want.sector_tag(r, c)
        flat = rng.integers(0, rows * cols, 50)
        origin = (int(rng.integers(0, 3)), int(rng.integers(0, 3)))
        for g, w in zip(got.flat_to_touch_arrays(flat, origin),
                        want.flat_to_touch_arrays(flat, origin)):
            np.testing.assert_array_equal(g, w)
        tags = np.arange(want.n_sectors)
        for t in tags[:: max(1, len(tags) // 17)]:
            assert got.tag_to_coords(int(t)) == want.tag_to_coords(int(t))
        # the reference's valid-words rule (heatmap.RegionHeatmap.valid_words)
        row0 = (tags // want.lane_tiles) * want.sublanes
        np.testing.assert_array_equal(
            got.valid_words_array(tags),
            np.clip(rows - row0, 1, want.sublanes),
        )


def test_block_to_2d_matches_reference():
    cases = [
        ((64,), (3,), (16,)),
        ((32, 48), (2, 1), (8, 16)),
        ((4, 8, 32), (1, 0, 1), (1, 8, 16)),
        ((4, 8, 32), (2, 0, 0), (2, 8, 32)),
    ]
    for shape, idx, block in cases:
        assert block_to_2d(shape, idx, block) == ref_block_to_2d(shape, idx, block)
    with pytest.raises(ValueError):
        block_to_2d((4, 8, 32), (0, 0, 0), (2, 4, 32))


def _pairs(arrays):
    tags, words = arrays
    return list(zip(tags.tolist(), words.tolist()))


def test_h100_sector_f32_row():
    g = H100Sector((4, 16), 4)
    assert (g.words_per_sector, g.word_bytes, g.sector_bytes) == (8, 4, 32)
    assert g.n_sectors == 8  # 4 rows x 64 B
    # row 1, cols 6..9: bytes 88..103 -> words 22..25 -> sectors 2, 3
    assert _pairs(g.slice_to_touch_arrays(1, 2, 6, 10)) == [
        (2, 6), (2, 7), (3, 0), (3, 1)
    ]
    assert g.is_aligned_slice(0, 4, 0, 8)
    assert not g.is_aligned_slice(0, 1, 1, 9)
    assert g.tag_to_coords(3) == (1, 8)


def test_h100_sector_bf16_packs_two_elements_per_word():
    g = H100Sector((2, 32), 2)
    assert g.n_sectors == 4  # 2 rows x 64 B
    # cols 0..3 of row 0: bytes 0..7 -> words 0, 1
    assert _pairs(g.slice_to_touch_arrays(0, 1, 0, 4)) == [(0, 0), (0, 1)]
    # col 17 of row 1: byte 98 -> word 24 -> sector 3 word 0
    assert _pairs(g.flat_to_touch_arrays(np.array([32 + 17]))) == [(3, 0)]
    # a sector holds 16 bf16 elements
    assert g.tag_to_coords(1) == (0, 16)
    assert not g.is_aligned_slice(0, 1, 0, 8)
    assert g.is_aligned_slice(0, 2, 0, 16)


def test_h100_sector_rows_straddle_sectors():
    # 5 f32 per row = 20 B: rows are not sector (or 8-element) multiples
    g = H100Sector((6, 5), 4)
    assert g.n_sectors == 4  # 120 B -> 30 words -> 4 sectors
    # column 4 of rows 0..5: elements 4, 9, 14, 19, 24, 29
    assert _pairs(g.slice_to_touch_arrays(0, 6, 4, 5)) == [
        (0, 4), (1, 1), (1, 6), (2, 3), (3, 0), (3, 5)
    ]
    # rows 1..2 in full are one run: words 5..14
    assert _pairs(g.slice_to_touch_arrays(1, 3, 0, 5)) == [
        (0, 5), (0, 6), (0, 7), (1, 0), (1, 1), (1, 2), (1, 3), (1, 4),
        (1, 5), (1, 6)
    ]
    # the last sector holds words 24..29 only
    np.testing.assert_array_equal(g.valid_words_array(np.arange(4)), [8, 8, 8, 6])
    assert g.tag_to_coords(1) == (1, 3)  # element 8 starts sector 1


def test_h100_sector_bf16_odd_rows_share_boundary_words():
    # 3 bf16 per row = 6 B: rows 0 and 1 share word 1 (bytes 4..7)
    g = H100Sector((4, 3), 2)
    assert _pairs(g.slice_to_touch_arrays(0, 2, 2, 3)) == [(0, 1), (0, 2)]
    assert _pairs(g.slice_to_touch_arrays(0, 2, 0, 1)) == [(0, 0), (0, 1)]


def test_h100_sector_1d_runs_and_wide_elements():
    g = H100Sector((100,), 4)
    assert g.shape2d == (1, 100)
    # elements 6..9 -> words 6..9 -> sector 0 words 6, 7 and sector 1 words 0, 1
    assert _pairs(g.run_to_touch_arrays(6, 10)) == [(0, 6), (0, 7), (1, 0), (1, 1)]
    assert _pairs(g.run_to_touch_arrays(98, 200)) == [(12, 2), (12, 3)]
    assert _pairs(g.run_to_touch_arrays(5, 5)) == []
    # an 8-byte element spans two words
    g8 = H100Sector((10,), 8)
    assert _pairs(g8.flat_to_touch_arrays(np.array([3]))) == [(0, 6), (0, 7)]
    assert _pairs(g8.run_to_touch_arrays(3, 5)) == [(0, 6), (0, 7), (1, 0), (1, 1)]


def test_make_geometry():
    assert isinstance(make_geometry("h100-sector", (4, 4), 4), H100Sector)
    assert isinstance(make_geometry("tpu-tile", (4, 4), 4), TPUTile)
    with pytest.raises(ValueError):
        make_geometry("nope", (4, 4), 4)
