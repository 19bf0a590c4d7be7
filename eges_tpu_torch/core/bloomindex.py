"""Sectioned, bitsliced log-bloom index (the core/bloombits role).

The port's copy of ``eges_tpu/core/bloomindex.py``, unchanged but for its
imports.

The reference builds a "bloombits" index (core/bloombits/generator.go,
matcher.go): headers' 2048-bit log blooms are batched into fixed-size
sections and TRANSPOSED, so each of the 2048 bloom bit-positions becomes
one contiguous bit-vector of "which blocks in this section set that
bit".  A log query then reads 3 vectors per filtered value and ANDs
them — O(sections) index reads instead of O(blocks) header scans.

Same design here, re-shaped for vector hardware instead of goroutine
pipelines: a section is a ``[2048, SECTION/8]`` uint8 matrix, queries
are numpy bitwise AND/OR over whole rows (the reference fans each bit
out to worker goroutines; a row op IS the batch here), and the index is
maintained incrementally on insert instead of by a background indexer
(core/chain_indexer.go) — the chain's single insert funnel makes the
"section not yet generated" state of the reference unnecessary except
for the live head section, which is simply also queryable.

Memory: 64 KiB per 256-block section — ~25 MiB per 100k blocks.
"""

from __future__ import annotations

import numpy as np

from eges_tpu_torch.core.state import bloom_bits

SECTION = 256  # blocks per section (divisible by 8)


class BloomIndex:
    """Incremental bitsliced index over header blooms.

    ``add(number, bloom)`` slots one header; ``candidates(...)`` returns
    the block numbers whose blooms may match a filter, reading 3 rows
    per value instead of walking headers.  False positives are inherent
    (blooms); false negatives are impossible for indexed blocks.
    Numbers never indexed (pre-index history on an old store) are
    reported via ``covered`` so callers can fall back to scanning.
    """

    def __init__(self):
        # section -> [2048, SECTION//8] uint8 bit matrix
        self._sections: dict[int, np.ndarray] = {}
        # per-section bitmap of which block slots are indexed at all
        self._present: dict[int, np.ndarray] = {}

    def add(self, number: int, bloom: bytes) -> None:
        sec, off = divmod(number, SECTION)
        m = self._sections.get(sec)
        if m is None:
            m = self._sections[sec] = np.zeros((2048, SECTION // 8),
                                               np.uint8)
            self._present[sec] = np.zeros(SECTION // 8, np.uint8)
        byte, bit = divmod(off, 8)
        mask = np.uint8(1 << bit)
        # clear first: a reorg re-adds the same height with a new bloom
        m[:, byte] &= np.uint8(~(1 << bit) & 0xFF)
        self._present[sec][byte] |= mask
        if bloom != bytes(256):
            bits = np.unpackbits(np.frombuffer(bloom, np.uint8))  # MSB-first
            # bloom bit k = byte 255 - k//8, bit k%8  ->  unpacked index
            # 2047 - k; flip so row index == bloom bit position
            m[:, byte] |= np.where(bits[::-1] == 1, mask, np.uint8(0))

    def truncate(self, from_number: int) -> None:
        """Drop every indexed block >= ``from_number`` (reorg rewind);
        the replay of the replacement suffix re-adds them."""
        first_sec, off = divmod(from_number, SECTION)
        for sec in [s for s in self._sections if s > first_sec]:
            del self._sections[sec]
            del self._present[sec]
        if off and first_sec in self._sections:
            keep = np.zeros(SECTION, np.uint8)
            keep[:off] = 1
            keep_mask = np.packbits(keep, bitorder="little")
            self._sections[first_sec] &= keep_mask
            self._present[first_sec] &= keep_mask
        elif not off:
            self._sections.pop(first_sec, None)
            self._present.pop(first_sec, None)

    def _value_vec(self, sec_matrix: np.ndarray, value: bytes) -> np.ndarray:
        b0, b1, b2 = bloom_bits(value)
        return sec_matrix[b0] & sec_matrix[b1] & sec_matrix[b2]

    def candidates(self, from_n: int, to_n: int, addresses,
                   topics) -> tuple[list[int], list[tuple[int, int]]]:
        """Block numbers in ``[from_n, to_n]`` whose blooms may match.

        ``addresses``: set of 20-byte addresses (empty = wildcard);
        ``topics``: list of per-position constraints, each ``None``
        (wildcard) or a set of acceptable 32-byte topics — the
        eth_getLogs filter shape.

        Returns ``(numbers, gaps)``: candidate block numbers from the
        indexed range, plus ``(lo, hi)`` inclusive sub-ranges that were
        never indexed and must be scanned by the caller.
        """
        numbers: list[int] = []
        gaps: list[tuple[int, int]] = []
        constraints = ([set(addresses)] if addresses else []) + [
            t for t in topics if t is not None]
        for sec in range(from_n // SECTION, to_n // SECTION + 1):
            lo = max(from_n, sec * SECTION)
            hi = min(to_n, sec * SECTION + SECTION - 1)
            m = self._sections.get(sec)
            present = self._present.get(sec)
            if m is None:
                gaps.append((lo, hi))
                continue
            vec = np.full(SECTION // 8, 0xFF, np.uint8)
            for cons in constraints:
                alt = np.zeros(SECTION // 8, np.uint8)
                for value in cons:
                    alt |= self._value_vec(m, value)
                vec &= alt
            # only indexed slots count as answered; unindexed slots in a
            # live section are gaps (shouldn't happen under the single
            # insert funnel, but replay from an older store could).
            # All row math stays vectorized: flatnonzero over the window
            # instead of a per-block walk — the whole point of the index.
            base = lo  # window start in absolute block numbers
            w = slice(lo - sec * SECTION, hi - sec * SECTION + 1)
            hit = np.unpackbits(vec & present, bitorder="little")[w]
            answered = np.unpackbits(present, bitorder="little")[w]
            numbers.extend((base + np.flatnonzero(hit)).tolist())
            un = np.flatnonzero(answered == 0)
            if un.size:
                cuts = np.flatnonzero(np.diff(un) != 1)
                starts = np.concatenate(([0], cuts + 1))
                ends = np.concatenate((cuts, [un.size - 1]))
                for s, e in zip(starts, ends):
                    gaps.append((base + int(un[s]), base + int(un[e])))
        # coalesce gap runs that abut across section boundaries
        merged: list[tuple[int, int]] = []
        for g_lo, g_hi in gaps:
            if merged and merged[-1][1] + 1 == g_lo:
                merged[-1] = (merged[-1][0], g_hi)
            else:
                merged.append((g_lo, g_hi))
        return numbers, merged
