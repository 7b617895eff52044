"""Pluggable word/sector geometry: the GPU granularity and the TPU tile.

CUTHERMO counts distinct warps per *word* and per *sector*.  On an
NVIDIA GPU a 128 B cache line splits into four 32 B sectors (the
memory-transaction unit), and each sector holds eight 4 B words (the
thread-access unit).  The JAX package maps that onto the TPU's native
tile (sector) and sublane row (word); this port runs the same engine
under either mapping, chosen per region:

    H100Sector  sector = 32 B of the region's row-major bytes, word = 4 B.
                Sector tag = byte offset // 32, word = (byte offset %
                32) // 4.  A bf16 word holds two elements, an 8-byte
                element spans two words, and a sector may straddle two
                rows when the row width is not a multiple of 32 B.
    TPUTile     the JAX package's tile geometry, reproduced exactly:
                (8/16/32 sublanes x 128 lanes) tiles of the last two
                dims, one word per sublane row.  It exists so that the
                port's engine can be held array for array against the
                reference on the reference's own kernel specs.

Both implement :class:`Geometry`, the whole surface the collector, the
analyzer, the pattern detectors, the renderer and the artifact loader
ask of a region's layout.  Addresses passed in are *element* offsets of
the region's 2-D view (leading dims flattened into rows; a 1-D array is
one row).
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, Dict, Protocol, Sequence, Tuple, Type

import numpy as np

LANES = 128

# sublanes per TPU native tile, keyed by dtype itemsize (bytes)
SUBLANES_BY_ITEMSIZE = {8: 4, 4: 8, 2: 16, 1: 32}


def sublanes_for(itemsize: int) -> int:
    """Sublane count of the TPU native tile for a dtype of ``itemsize`` bytes."""
    try:
        return SUBLANES_BY_ITEMSIZE[int(itemsize)]
    except KeyError as e:
        raise ValueError(f"unsupported itemsize {itemsize}") from e


def _rows_cols(shape: Tuple[int, ...]) -> Tuple[int, int]:
    """The 2-D view of an N-D shape: leading dims flattened into rows."""
    if len(shape) == 0:
        return (1, 1)
    if len(shape) == 1:
        return (1, int(shape[0]))
    return (int(np.prod(shape[:-1], dtype=np.int64)), int(shape[-1]))


class Geometry(Protocol):
    """What the engine asks of one region's word/sector layout.

    ``kind`` names the implementation in artifacts.  Touch arrays are
    parallel int64 ``(tags, words)``; the slice and run forms return each
    pair at most once, the flat form one entry per element (callers
    dedupe).
    """

    kind: ClassVar[str]
    shape: Tuple[int, ...]
    itemsize: int
    name: str

    @property
    def shape2d(self) -> Tuple[int, int]: ...

    @property
    def words_per_sector(self) -> int: ...

    @property
    def word_bytes(self) -> int: ...

    @property
    def sector_bytes(self) -> int: ...

    @property
    def n_sectors(self) -> int: ...

    def tag_to_coords(self, tag: int) -> Tuple[int, int]: ...

    def slice_to_touch_arrays(
        self, row_start: int, row_stop: int, col_start: int, col_stop: int
    ) -> Tuple[np.ndarray, np.ndarray]: ...

    def run_to_touch_arrays(
        self, start: int, stop: int
    ) -> Tuple[np.ndarray, np.ndarray]: ...

    def flat_to_touch_arrays(
        self, flat: np.ndarray, origin: Tuple[int, int] = (0, 0)
    ) -> Tuple[np.ndarray, np.ndarray]: ...

    def valid_words_array(self, tags: np.ndarray) -> np.ndarray: ...

    def is_aligned_slice(
        self, row_start: int, row_stop: int, col_start: int, col_stop: int
    ) -> bool: ...


@dataclasses.dataclass(frozen=True)
class TPUTile:
    """The JAX package's TPU tile geometry, bit for bit.

    The last two array dims map to (sublane, lane); leading dims are
    flattened into rows of tiles.  1-D arrays are stored as rows of 128
    lanes.  A word is one (1, 128) sublane row, a sector one native tile.
    """

    shape: Tuple[int, ...]
    itemsize: int
    name: str = "array"
    kind: ClassVar[str] = "tpu-tile"

    @property
    def shape2d(self) -> Tuple[int, int]:
        if len(self.shape) == 1:
            return (max(1, math.ceil(self.shape[0] / LANES)), LANES)
        return _rows_cols(self.shape)

    @property
    def sublanes(self) -> int:
        return sublanes_for(self.itemsize)

    @property
    def words_per_sector(self) -> int:
        return self.sublanes

    @property
    def lane_tiles(self) -> int:
        """Tiles along the lane (minor) dimension, padded up."""
        return max(1, math.ceil(self.shape2d[1] / LANES))

    @property
    def sublane_tiles(self) -> int:
        """Tiles along the sublane (major) dimension, padded up."""
        return max(1, math.ceil(self.shape2d[0] / self.sublanes))

    @property
    def n_sectors(self) -> int:
        return self.lane_tiles * self.sublane_tiles

    @property
    def sector_bytes(self) -> int:
        return self.sublanes * LANES * self.itemsize

    @property
    def word_bytes(self) -> int:
        return LANES * self.itemsize

    def sector_tag(self, row: int, col: int) -> int:
        """Sector tag for element (row, col) of the 2-D view."""
        return (row // self.sublanes) * self.lane_tiles + col // LANES

    def tag_to_coords(self, tag: int) -> Tuple[int, int]:
        """Top-left element (row, col) of the tile."""
        st, lt = divmod(tag, self.lane_tiles)
        return st * self.sublanes, lt * LANES

    def slice_to_touch_arrays(
        self, row_start: int, row_stop: int, col_start: int, col_stop: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(tags, words) of a clipped 2-D slice, row-major, each pair once."""
        rows, cols = self.shape2d
        row_start, col_start = max(0, row_start), max(0, col_start)
        row_stop, col_stop = min(rows, row_stop), min(cols, col_stop)
        if row_stop <= row_start or col_stop <= col_start:
            z = np.empty(0, dtype=np.int64)
            return z, z
        r = np.arange(row_start, row_stop, dtype=np.int64)
        lt = np.arange(
            col_start // LANES, (col_stop - 1) // LANES + 1, dtype=np.int64
        )
        tags = ((r // self.sublanes) * self.lane_tiles)[:, None] + lt[None, :]
        words = np.broadcast_to((r % self.sublanes)[:, None], tags.shape)
        return tags.reshape(-1), words.reshape(-1).copy()

    def run_to_touch_arrays(
        self, start: int, stop: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(tags, words) of a contiguous 1-D element run (lane rows)."""
        n = self.shape[0] if len(self.shape) == 1 else int(np.prod(self.shape))
        start, stop = max(0, start), min(n, stop)
        if stop <= start:
            z = np.empty(0, dtype=np.int64)
            return z, z
        row = np.arange(start // LANES, (stop - 1) // LANES + 1, dtype=np.int64)
        return (row // self.sublanes) * self.lane_tiles, row % self.sublanes

    def flat_to_touch_arrays(
        self, flat: np.ndarray, origin: Tuple[int, int] = (0, 0)
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Flat element index -> (tags, words), shifted by ``origin``."""
        flat = np.asarray(flat, dtype=np.int64).reshape(-1)
        _, cols = self.shape2d
        r = flat // cols + origin[0]
        c = flat % cols + origin[1]
        tags = (r // self.sublanes) * self.lane_tiles + c // LANES
        return tags, r % self.sublanes

    def valid_words_array(self, tags: np.ndarray) -> np.ndarray:
        """Words that exist in each tile (edge tiles may have fewer rows)."""
        row0 = (np.asarray(tags) // self.lane_tiles) * self.sublanes
        return np.clip(self.shape2d[0] - row0, 1, self.sublanes)

    def is_aligned_slice(
        self, row_start: int, row_stop: int, col_start: int, col_stop: int
    ) -> bool:
        """True iff the slice starts/ends on tile boundaries (or array edge)."""
        rows, cols = self.shape2d
        ok_r = (row_start % self.sublanes == 0) and (
            row_stop % self.sublanes == 0 or row_stop >= rows
        )
        ok_c = (col_start % LANES == 0) and (
            col_stop % LANES == 0 or col_stop >= cols
        )
        return ok_r and ok_c


@dataclasses.dataclass(frozen=True)
class H100Sector:
    """NVIDIA sector geometry over the region's row-major bytes.

    Element (row, col) of the 2-D view lives at byte
    ``(row * cols + col) * itemsize``.  Touching any byte of a 4 B word
    touches the word; a sector (32 B, eight words) is what one memory
    transaction moves, exactly as in the CUTHERMO paper.
    """

    shape: Tuple[int, ...]
    itemsize: int
    name: str = "array"
    kind: ClassVar[str] = "h100-sector"
    WORD: ClassVar[int] = 4
    SECTOR: ClassVar[int] = 32

    @property
    def shape2d(self) -> Tuple[int, int]:
        return _rows_cols(self.shape)

    @property
    def words_per_sector(self) -> int:
        return self.SECTOR // self.WORD

    @property
    def word_bytes(self) -> int:
        return self.WORD

    @property
    def sector_bytes(self) -> int:
        return self.SECTOR

    @property
    def n_bytes(self) -> int:
        rows, cols = self.shape2d
        return rows * cols * int(self.itemsize)

    @property
    def n_words(self) -> int:
        return max(1, math.ceil(self.n_bytes / self.WORD))

    @property
    def n_sectors(self) -> int:
        return max(1, math.ceil(self.n_bytes / self.SECTOR))

    def tag_to_coords(self, tag: int) -> Tuple[int, int]:
        """(row, col) of the first element that starts in the sector."""
        elem = -(-int(tag) * self.SECTOR // int(self.itemsize))
        return divmod(elem, self.shape2d[1])

    def _split(self, w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        wps = self.words_per_sector
        return w // wps, w % wps

    def _ranges_to_touch_arrays(
        self, lo: np.ndarray, hi: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Touches of the inclusive word ranges [lo[i], hi[i]], ascending.

        The ranges are sorted and may only share their boundary words
        (neighbouring rows whose byte width is not a multiple of 4), so
        the result needs a dedupe only in that case.
        """
        n = hi - lo + 1
        total = int(n.sum())
        offsets = np.repeat(np.cumsum(n) - n, n)
        w = np.arange(total, dtype=np.int64) - offsets + np.repeat(lo, n)
        if lo.shape[0] > 1 and np.any(lo[1:] <= hi[:-1]):
            w = np.unique(w)
        return self._split(w)

    def slice_to_touch_arrays(
        self, row_start: int, row_stop: int, col_start: int, col_stop: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(tags, words) of a clipped 2-D slice, ascending, each pair once."""
        rows, cols = self.shape2d
        row_start, col_start = max(0, row_start), max(0, col_start)
        row_stop, col_stop = min(rows, row_stop), min(cols, col_stop)
        if row_stop <= row_start or col_stop <= col_start:
            z = np.empty(0, dtype=np.int64)
            return z, z
        isz = int(self.itemsize)
        base = np.arange(row_start, row_stop, dtype=np.int64) * cols
        if col_start == 0 and col_stop == cols:
            # whole rows are one contiguous byte run
            base = base[:1]
            col_stop = cols * (row_stop - row_start)
        lo = (base + col_start) * isz // self.WORD
        hi = ((base + col_stop) * isz - 1) // self.WORD
        return self._ranges_to_touch_arrays(lo, hi)

    def run_to_touch_arrays(
        self, start: int, stop: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(tags, words) of a contiguous run of flat elements."""
        rows, cols = self.shape2d
        start, stop = max(0, start), min(rows * cols, stop)
        if stop <= start:
            z = np.empty(0, dtype=np.int64)
            return z, z
        isz = int(self.itemsize)
        lo = np.asarray([start * isz // self.WORD], dtype=np.int64)
        hi = np.asarray([(stop * isz - 1) // self.WORD], dtype=np.int64)
        return self._ranges_to_touch_arrays(lo, hi)

    def flat_to_touch_arrays(
        self, flat: np.ndarray, origin: Tuple[int, int] = (0, 0)
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Flat element index -> (tags, words), shifted by ``origin``.

        One entry per element, or two for an element wider than a word.
        """
        flat = np.asarray(flat, dtype=np.int64).reshape(-1)
        _, cols = self.shape2d
        elem = (flat // cols + origin[0]) * cols + flat % cols + origin[1]
        isz = int(self.itemsize)
        first = elem * isz // self.WORD
        span = max(1, isz // self.WORD)
        w = (first[:, None] + np.arange(span, dtype=np.int64)).reshape(-1)
        return self._split(w)

    def valid_words_array(self, tags: np.ndarray) -> np.ndarray:
        """Words of each sector that lie inside the region's bytes."""
        wps = self.words_per_sector
        return np.clip(self.n_words - np.asarray(tags) * wps, 1, wps)

    def is_aligned_slice(
        self, row_start: int, row_stop: int, col_start: int, col_stop: int
    ) -> bool:
        """True iff every row of the slice starts and ends on a sector
        boundary (or at the end of the region)."""
        _, cols = self.shape2d
        isz = int(self.itemsize)
        base = np.arange(row_start, max(row_start + 1, row_stop)) * cols
        starts = (base + col_start) * isz
        stops = (base + col_stop) * isz
        return bool(
            np.all(starts % self.SECTOR == 0)
            and np.all((stops % self.SECTOR == 0) | (stops >= self.n_bytes))
        )


GEOMETRIES: Dict[str, Type] = {g.kind: g for g in (TPUTile, H100Sector)}


def make_geometry(
    kind: str, shape: Sequence[int], itemsize: int, name: str = "array"
) -> Geometry:
    """Build the geometry named ``kind`` for one region."""
    try:
        cls = GEOMETRIES[kind]
    except KeyError:
        raise ValueError(
            f"unknown geometry {kind!r}; known: {', '.join(GEOMETRIES)}"
        ) from None
    return cls(
        shape=tuple(int(s) for s in shape), itemsize=int(itemsize), name=name
    )


def block_to_2d(
    shape: Sequence[int], index: Sequence[int], block_shape: Sequence[int]
) -> Tuple[int, int, int, int]:
    """Map an N-D block (block coords * block_shape) to a 2-D slice.

    Leading dims are flattened row-major into the row axis.  Returns
    (row_start, row_stop, col_start, col_stop).  Raises ``ValueError``
    for a leading block that is not contiguous in flattened rows.
    """
    shape = tuple(int(s) for s in shape)
    index = tuple(int(i) for i in index)
    block_shape = tuple(int(b) for b in block_shape)
    if len(shape) == 0:
        return (0, 1, 0, 1)
    if len(shape) == 1:
        c0 = index[0] * block_shape[0]
        return (0, 1, c0, c0 + block_shape[0])
    c0 = index[-1] * block_shape[-1]
    lead_shape, lead_block = shape[:-1], block_shape[:-1]
    row0 = 0
    for i, b, dim in zip(index[:-1], lead_block, lead_shape):
        row0 = row0 * dim + i * b
    for i, b in enumerate(lead_block):
        if b > 1 and any(
            lead_block[j] != lead_shape[j] for j in range(i + 1, len(lead_block))
        ):
            raise ValueError("non-contiguous leading block; enumerate per-dim")
    nrows = int(np.prod(lead_block, dtype=np.int64))
    return (row0, row0 + nrows, c0, c0 + block_shape[-1])
