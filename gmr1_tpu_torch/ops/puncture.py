"""GMR-1 puncturing (ETSI TS 101 376-5-3 §4.5).

A puncturing scheme is a (pre, main, post) triple of bit masks applied
over the convolutional coder output; positions where the mask is 0 are
deleted (reference src/l1/punct.c:49-133).  The TPU-native form computes,
per channel configuration, two static index tables:

  keep[out_len_punct]   gather for puncturing (encode side)
  scatter == keep       used to de-puncture by writing soft bits into a
                        zero (erasure) vector (decode side)

Both sides are then a single gather / scatter with static indices.

The mask catalog below carries the full set of 51 named schemes from the
reference (punct.c:137-1166, extern list punct.h:56-106) keyed the same
way so every channel configuration in the spec can be expressed.  Masks
are spec data (not code) and were transcribed via tools/extract_ref_data.py.
Note gmr1_punct_k5_12_E's mask contains a literal `2` in the reference
(punct.c:318) — kept verbatim here; any nonzero value means "keep", so
that scheme punctures nothing despite r=1 (latent reference quirk; the
scheme is unused by any coder).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np


@dataclass(frozen=True)
class Puncturer:
    r: int          # punctured bits per mask period
    length: int     # mask period in symbols (L)
    n: int          # code rate denominator this mask applies to
    mask: tuple[int, ...]  # length L*N; 0 = delete


def _p(r, length, n, mask: str) -> Puncturer:
    return Puncturer(r, length, n, tuple(int(c) for c in mask))


# Mask catalog — spec data, names follow reference punct.h:56-106.
PUNCT = {
    "k5_12_P23": _p(2, 3, 2, "011011"),
    "k5_12_P25": _p(2, 5, 2, "1011101111"),
    "k5_12_Ps25": _p(2, 5, 2, "1111101110"),
    "k5_12_P311": _p(3, 11, 2, "1011101111101111111111"),
    "k5_12_P412": _p(4, 12, 2, "101110111011101111111111"),
    "k5_12_Ps412": _p(4, 12, 2, "111111111110111011101110"),
    "k5_12_P12": _p(1, 2, 2, "1110"),
    "k5_12_Ps12": _p(1, 2, 2, "1011"),
    "k5_12_A": _p(0, 4, 2, "11111111"),
    "k5_12_B": _p(1, 4, 2, "10111111"),
    "k5_12_C": _p(2, 4, 2, "10111011"),
    "k5_12_D": _p(3, 4, 2, "01100111"),
    "k5_12_E": _p(1, 4, 2, "12111111"),
    "k5_12_P38": _p(3, 8, 2, "0111011111111011"),
    "k5_12_P26": _p(2, 6, 2, "101111101111"),
    "k5_12_P37": _p(3, 7, 2, "10111011101111"),
    "k5_13_P16": _p(1, 6, 3, "110111111111111111"),
    "k5_13_P25": _p(2, 5, 3, "111111101111101"),
    "k5_13_P15": _p(1, 5, 3, "101111111111111"),
    "k5_13_Ps15": _p(1, 5, 3, "111111111111101"),
    "k5_13_P78": _p(7, 8, 3, "001110111011111110101101"),
    "k5_15_P23": _p(2, 3, 5, "111111101111110"),
    "k5_15_P53": _p(5, 3, 5, "111011001111100"),
    "k5_15_Ps53": _p(5, 3, 5, "111001001111101"),
    "k7_12_P23": _p(2, 3, 2, "111001"),
    "k7_12_P410": _p(4, 10, 2, "10111011101111111011"),
    "k7_12_P512": _p(5, 12, 2, "111011101111111011101110"),
    "k7_12_P116": _p(1, 16, 2, "1" + "0" + "1" * 30),
    "k7_12_P148": _p(1, 48, 2, "1" + "0" + "1" * 94),
    "k7_12_P184": _p(1, 84, 2, "1" + "0" + "1" * 166),
    "k7_12_P1152": _p(1, 152, 2, "1" + "0" + "1" * 302),
    "k7_12_P45": _p(4, 5, 2, "0111100110"),
    "k7_12_P245": _p(4, 5, 2, "1001100111"),
    "k9_12_P13": _p(1, 3, 2, "101111"),
    "k9_12_P47": _p(4, 7, 2, "01111011101110"),
    "k9_12_P34": _p(3, 4, 2, "11100110"),
    "k9_12_P17": _p(1, 7, 2, "10111111111111"),
    "k9_12_P19": _p(1, 9, 2, "011111111111111111"),
    "k9_12_P26": _p(2, 6, 2, "101111101111"),
    "k9_12_P110": _p(1, 10, 2, "01111111111111111111"),
    "k9_12_P14": _p(1, 4, 2, "10111111"),
    "k9_12_P45": _p(4, 5, 2, "0111011010"),
    "k9_12_P234": _p(3, 4, 2, "10011011"),
    "k6_14_P45": _p(4, 5, 4, "10111011111011111110"),
    "k9_14_P148": _p(14, 8, 4, "10011010101010011101100110011101"),
    "k9_14_P65": _p(6, 5, 4, "01111011111100101011"),
    "k9_13_P12": _p(1, 2, 3, "111011"),
    "k9_13_P1213": _p(12, 13, 3, "110101011110101011110101011110101011111"),
    "k9_13_P44": _p(4, 4, 3, "110011101110"),
    "k9_13_P33": _p(3, 3, 3, "011101110"),
    "k9_13_P65": _p(6, 5, 3, "101011100011110"),
}


@lru_cache(maxsize=None)
def punct_indices(
    out_len: int,
    n: int,
    main: str,
    pre: str | None = None,
    post: str | None = None,
    repeat: int = 0,
) -> np.ndarray:
    """Indices (ascending) into the unpunctured output that are DELETED.

    Follows gmr1_puncturer_generate (reference punct.c:49-133): the pre
    mask covers the first pre.L*N output bits, the main mask repeats
    `repeat` times (auto-extended to cover the remainder when 0), and the
    post mask covers the last post.L*N bits.
    """
    p_pre = PUNCT[pre] if pre else None
    p_main = PUNCT[main]
    p_post = PUNCT[post] if post else None
    for p in (p_pre, p_main, p_post):
        if p is not None:
            assert p.n == n, f"mask rate {p.n} != code rate {n}"

    cl = out_len
    if not repeat:
        c = cl
        if p_pre:
            c -= p_pre.length * n
        if p_post:
            c -= p_post.length * n
        d = p_main.length * n
        repeat = (c + d - 1) // d

    deleted: list[int] = []
    ii = 0
    if p_pre:
        for ip in range(p_pre.length * n):
            if ii >= cl:
                break
            if p_pre.mask[ip] == 0:
                deleted.append(ii)
            ii += 1
    main_end = cl - (p_post.length * n if p_post else 0)
    for _ in range(repeat):
        for ip in range(p_main.length * n):
            if ii >= main_end:
                break
            if p_main.mask[ip] == 0:
                deleted.append(ii)
            ii += 1
    if p_post:
        ii = main_end
        for ip in range(p_post.length * n):
            if p_post.mask[ip] == 0:
                deleted.append(ii)
            ii += 1
    return np.asarray(sorted(deleted), dtype=np.int32)


@lru_cache(maxsize=None)
def keep_indices(out_len: int, n: int, main: str, pre=None, post=None,
                 repeat: int = 0) -> np.ndarray:
    """Complement of punct_indices: surviving positions, in order."""
    deleted = punct_indices(out_len, n, main, pre, post, repeat)
    keep = np.ones(out_len, dtype=bool)
    keep[deleted] = False
    return np.nonzero(keep)[0].astype(np.int32)
