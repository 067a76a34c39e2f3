"""RaggedBatcher — load-balanced regrouping of ragged vision requests.

The packed ViT's dynamic token pruning makes the in-flight population
*ragged*: every image enters with its own patch count and sheds tokens at
each TDM layer according to its own keep rate, so at any instant the live
requests sit at different segments with diverging token counts. The
SBMM / attention kernels want rectangular work. The batcher is the bridge —
the software twin of the paper's load-balancing of irregular block-pruned
work across PE lanes: at every segment boundary it bin-packs the survivors
into dense tiles.

Two packing modes (the vision bench A/Bs them):

* ``balanced`` — requests are grouped into *token-count buckets*: the
  bucket key is the token count rounded up to ``token_tile`` (default 1 =
  exact counts) and the batch dimension is padded to the next power of two.
  With ``token_tile == 1`` no token padding exists, so results are
  bit-exact against the single-request path; larger tiles trade a bounded
  amount of (masked) padding for fewer distinct compiled shapes.
* ``naive``   — the classic padded batch: per segment, ONE tile padded to
  the largest member's token count and to ``max_batch`` rows. Small images
  pay the largest image's quadratic attention cost; the bench shows the
  throughput gap.

Guarantees (property-tested in tests/test_ragged_batcher.py):
  * every item lands in exactly one tile (zero dropped requests);
  * per-row token padding < ``token_tile`` (== 0 when ``token_tile`` is 1)
    in balanced mode;
  * batch padding < the tile's member count (next-pow2 rounding), so a
    tile's padded cell area is < 4x its real cell area when
    ``token_tile`` is 1.

Distinct dispatched shapes are bounded by the bucket set: every tile maps
to a ``bucket_key`` = (stage key, token tile, batch tile), and the
engine's segment ledger records each distinct key once.

The batcher is the *grouping* layer; cost-driven rewrites of the grouping
(bucket merging, express-lane fusion, deadline splits) live above it in
``serving.planner.TilePlanner``, which calls :meth:`partition` /
:meth:`record` so this class keeps owning the padding/bucket accounting
for whatever was actually dispatched.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, List, Optional, Sequence, Tuple



def bucket_length(n: int, cap: int, lo: int = 8) -> int:
    """Round ``n`` up to the next power-of-two bucket in [lo, cap]."""
    b = max(int(lo), 1)
    while b < n:
        b *= 2
    return min(b, cap)


@dataclasses.dataclass(frozen=True)
class Tile:
    """One rectangular unit of work: ``members`` (caller-side item indices)
    stacked into a [b_tile, n_tile] token grid."""

    stage: Hashable            # opaque segment key (weights + static args)
    members: Tuple[int, ...]   # item indices covered by this tile
    n_tokens: Tuple[int, ...]  # per-member real token counts
    n_tile: int                # padded token count
    b_tile: int                # padded batch rows (>= len(members))

    @property
    def bucket_key(self) -> Tuple:
        """Dispatch-shape identity: tiles sharing it run the same kernel
        shapes (masked and unmasked variants of a shape are distinct, so the
        mask bit is part of the identity)."""
        return (self.stage, self.n_tile, self.b_tile, self.needs_mask)

    @property
    def real_cells(self) -> int:
        return sum(self.n_tokens)

    @property
    def padded_cells(self) -> int:
        return self.n_tile * self.b_tile

    @property
    def needs_mask(self) -> bool:
        """True when any member row is token-padded (engine must pass
        ``n_valid``); batch-only padding needs no mask — rows are
        independent."""
        return any(n != self.n_tile for n in self.n_tokens)


class RaggedBatcher:
    """Plans tiles over (stage, token-count) items; accumulates padding and
    bucket statistics across calls."""

    def __init__(self, token_tile: int = 1, mode: str = "balanced",
                 max_batch: Optional[int] = None):
        if token_tile <= 0:
            raise ValueError(f"token_tile must be positive, got {token_tile}")
        if mode not in ("balanced", "naive"):
            raise ValueError(f"mode must be 'balanced' or 'naive', "
                             f"got {mode!r}")
        if mode == "naive" and not max_batch:
            raise ValueError("naive mode pads to max_batch rows; pass it")
        self.token_tile = token_tile
        self.mode = mode
        self.max_batch = max_batch
        # cumulative accounting
        self.real_cells = 0
        self.padded_cells = 0
        self.tiles_planned = 0
        self.bucket_keys: set = set()

    # -- tiling rules ------------------------------------------------------
    def tile_tokens(self, n: int, cap: Optional[int] = None) -> int:
        t = self.token_tile
        tile = -(-n // t) * t
        if cap is not None:
            tile = min(tile, cap)  # never quantize past a hard shape bound
        return tile

    def tile_batch(self, b: int) -> int:
        # same pow2 bucketing as the LM path's prefix-length buckets
        return bucket_length(b, cap=self.max_batch or b, lo=1)

    # -- planning ----------------------------------------------------------
    def plan(self, items: Sequence[Tuple]) -> List[Tile]:
        """items: ``(stage_key, n_tokens)`` — or ``(stage_key, n_tokens,
        n_cap)`` where ``n_cap`` bounds the padded token tile (e.g. the
        position-table capacity at the embed stage) — per live request.
        Returns tiles covering every item exactly once, deterministically
        ordered, and records them into the cumulative stats. This is the
        *identity plan* — ``serving.planner.TilePlanner`` in mode ``off``
        reproduces it exactly; richer modes call :meth:`partition`,
        transform the tiles (merge/fuse/split), then :meth:`record` what
        was actually dispatched."""
        tiles = self.partition(items)
        self.record(tiles)
        return tiles

    def partition(self, items: Sequence[Tuple]) -> List[Tile]:
        """Pure grouping: the tiles of :meth:`plan` without touching the
        cumulative accounting (callers that rewrite the tiling — the
        ``TilePlanner`` — record the final tiles themselves)."""
        groups: Dict[Tuple, List[int]] = {}
        for idx, item in enumerate(items):
            stage, n = item[0], item[1]
            cap = item[2] if len(item) > 2 else None
            if n <= 0:
                raise ValueError(f"item {idx}: token count must be "
                                 f"positive, got {n}")
            if cap is not None and cap < n:
                raise ValueError(f"item {idx}: token cap {cap} below "
                                 f"count {n}")
            key = (stage,) if self.mode == "naive" \
                else (stage, self.tile_tokens(n, cap))
            groups.setdefault(key, []).append(idx)

        tiles: List[Tile] = []
        for key in sorted(groups, key=repr):
            members = groups[key]
            if self.mode == "naive":
                # one tile per stage, token-padded to the largest member,
                # batch-padded to the full slot width — but never beyond
                # it: overflow spills into further max_batch-wide tiles
                cap = self.max_batch
                for s in range(0, len(members), cap):
                    chunk = members[s: s + cap]
                    counts = tuple(items[i][1] for i in chunk)
                    tiles.append(Tile(
                        stage=key[0], members=tuple(chunk),
                        n_tokens=counts, n_tile=max(counts), b_tile=cap))
            else:
                cap = self.max_batch or len(members)
                for s in range(0, len(members), cap):
                    chunk = members[s: s + cap]
                    counts = tuple(items[i][1] for i in chunk)
                    tiles.append(Tile(
                        stage=key[0], members=tuple(chunk), n_tokens=counts,
                        n_tile=key[1], b_tile=self.tile_batch(len(chunk))))
        return tiles

    def record(self, tiles: Sequence[Tile]) -> None:
        """Fold dispatched tiles into the cumulative padding/bucket stats."""
        for t in tiles:
            self.real_cells += t.real_cells
            self.padded_cells += t.padded_cells
            self.tiles_planned += 1
            self.bucket_keys.add(t.bucket_key)

    # -- observability -----------------------------------------------------
    @property
    def bucket_count(self) -> int:
        """Distinct compile shapes planned so far — the recompile bound."""
        return len(self.bucket_keys)

    def padding_waste(self) -> float:
        """Fraction of dispatched cells that were padding."""
        if self.padded_cells == 0:
            return 0.0
        return 1.0 - self.real_cells / self.padded_cells

    def stats(self) -> Dict[str, float]:
        return {
            "mode": self.mode,
            "token_tile": self.token_tile,
            "tiles": self.tiles_planned,
            "buckets": self.bucket_count,
            "real_cells": self.real_cells,
            "padded_cells": self.padded_cells,
            "padding_waste": self.padding_waste(),
        }
