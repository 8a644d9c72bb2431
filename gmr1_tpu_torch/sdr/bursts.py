"""GMR-1 burst format catalog (reference src/sdr/nb.c, spec TS 101 376-5-2).

Pure data: modulation, guard symbols, sync-sequence chunk positions and
data chunk positions for every burst class.  Sync symbol values are in
"symbol index" units (0..2^nbits-1 modulating phase k*pi/2 — see the
symbol notation table at reference pi4cxpsk.c:46-68).

All positions are in symbols at 1 sps; a slot is 39 symbols.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

import numpy as np


@dataclass(frozen=True)
class Modulation:
    name: str
    rotation: float  # continuous rotation per symbol (rad)
    nbits: int       # bits per symbol

    @cached_property
    def sym_phase(self) -> np.ndarray:
        """Modulating phase of symbol index s = s * 2pi/M.

        Reference pi4cxpsk.c:71-74 (BPSK: 0 -> 0, 1 -> pi) and :94-99
        (QPSK: s -> s*pi/2).
        """
        m = 1 << self.nbits
        return np.arange(m) * (2.0 * np.pi / m)

    @cached_property
    def sym_val(self) -> np.ndarray:
        return np.exp(1j * self.sym_phase).astype(np.complex64)

    @cached_property
    def bits_of_sym(self) -> np.ndarray:
        """Data bits of each symbol index, MSB first (Gray for CQPSK).

        pi4cxpsk.c:93-99: sym 0->00, 1->01, 2->11, 3->10; BPSK: 0->0, 1->1.
        """
        if self.nbits == 1:
            return np.array([[0], [1]], dtype=np.uint8)
        return np.array([[0, 0], [0, 1], [1, 1], [1, 0]], dtype=np.uint8)

    @cached_property
    def sym_of_bits(self) -> np.ndarray:
        """Symbol index for packed data bits (inverse of bits_of_sym)."""
        inv = np.zeros(1 << self.nbits, dtype=np.int32)
        for s, bits in enumerate(self.bits_of_sym):
            v = 0
            for b in bits:
                v = (v << 1) | int(b)
            inv[v] = s
        return inv


PI2CBPSK = Modulation("pi2-cbpsk", np.pi / 2, 1)
PI4CBPSK = Modulation("pi4-cbpsk", np.pi / 4, 1)
PI4CQPSK = Modulation("pi4-cqpsk", np.pi / 4, 2)


@dataclass(frozen=True)
class SyncChunk:
    pos: int
    syms: tuple[int, ...]

    @property
    def length(self) -> int:
        return len(self.syms)


@dataclass(frozen=True)
class DataChunk:
    pos: int
    length: int


@dataclass(frozen=True)
class Burst:
    name: str
    mod: Modulation
    len_syms: int
    ebits: int
    guard_pre: int
    guard_post: int
    # sync[i] = tuple of chunks for sync sequence id i
    sync: tuple[tuple[SyncChunk, ...], ...]
    data: tuple[DataChunk, ...] = field(default=())

    @cached_property
    def data_positions(self) -> np.ndarray:
        """Symbol positions of all data symbols, in ebit order."""
        return np.concatenate(
            [np.arange(d.pos, d.pos + d.length) for d in self.data]
        ).astype(np.int32)

    def sync_ref(self, sync_id: int) -> list[np.ndarray]:
        """Reference waveform (complex, no pi/4 rotation) per chunk."""
        return [
            self.mod.sym_val[np.asarray(c.syms)] for c in self.sync[sync_id]
        ]

    @property
    def n_sync(self) -> int:
        return len(self.sync)


def _sync(*chunks) -> tuple[SyncChunk, ...]:
    return tuple(SyncChunk(pos, tuple(syms)) for pos, syms in chunks)


def _data(*chunks) -> tuple[DataChunk, ...]:
    return tuple(DataChunk(pos, ln) for pos, ln in chunks)


# Catalog — data transcribed from reference src/sdr/nb.c (cited per burst).

# nb.c:36-62 (TS 101 376-5-2 §7.4.2)
BCCH = Burst(
    "bcch", PI4CQPSK, 39 * 6, 424, 2, 3,
    sync=(_sync((28, (0, 2, 2, 0, 0, 0, 2, 0, 2, 2, 2)),
                (119, (2, 2, 0)), (197, (2, 2, 0))),),
    data=_data((2, 26), (39, 80), (122, 75), (200, 31)),
)

# nb.c:67-89 (§7.4.4)
DC2 = Burst(
    "dc2", PI4CQPSK, 39 * 2, 132, 2, 3,
    sync=(_sync((28, (0, 1, 2, 3, 0, 3, 0))),),
    data=_data((2, 26), (35, 40)),
)

# nb.c:94-120 (§7.4.5)
DC6 = Burst(
    "dc6", PI4CQPSK, 39 * 6, 432, 2, 3,
    sync=(_sync((28, (0, 0, 0, 2, 2, 0, 2)),
                (119, (0, 3, 0)), (197, (3, 1, 1))),),
    data=_data((2, 26), (35, 84), (122, 75), (200, 31)),
)

# nb.c:125-151 (§7.4.16) — pi/2-CBPSK
DC12 = Burst(
    "dc12", PI2CBPSK, 39 * 12, 432, 2, 3,
    sync=(_sync((10, (0, 0, 1, 0, 0, 0, 1, 1, 1, 1)),
                (228, (0, 0, 1, 0, 0, 0, 1, 1, 1, 0, 1)),
                (447, (0, 0, 1, 0, 0, 0, 1, 1, 1, 1))),),
    data=_data((2, 8), (20, 208), (239, 208), (457, 8)),
)

# nb.c:156-178 (§7.4.8.1)
NT3_SPEECH = Burst(
    "nt3_speech", PI4CQPSK, 39 * 3, 212, 2, 3,
    sync=(_sync((28, (0, 3, 3, 1, 2, 3))),),
    data=_data((2, 26), (34, 80)),
)

# nb.c:183-210 (§7.4.8.2) — two sync sequences, pi/4-CBPSK
NT3_FACCH = Burst(
    "nt3_facch", PI4CBPSK, 39 * 3, 104, 2, 3,
    sync=(_sync((28, (1, 0, 1, 0, 1, 0, 1, 0))),
          _sync((28, (1, 1, 0, 0, 1, 0, 0, 1)))),
    data=_data((2, 26), (36, 78)),
)

# nb.c:215-248 (§7.4.9)
NT6 = Burst(
    "nt6", PI4CQPSK, 39 * 6, 434, 2, 3,
    sync=(_sync((28, (0, 2, 2, 3, 2, 3)), (119, (0, 1, 0)), (197, (2, 3, 0))),
          _sync((28, (0, 0, 0, 2, 2, 0)), (119, (1, 3, 0)), (197, (2, 1, 3)))),
    data=_data((2, 26), (34, 85), (122, 75), (200, 31)),
)

# nb.c:253-289 (§7.4.10) — sync 0 = FACCH9, sync 1 = TCH9
NT9 = Burst(
    "nt9", PI4CQPSK, 39 * 9, 662, 2, 3,
    sync=(_sync((28, (0, 2, 2, 3, 2, 3)), (119, (1, 2, 2)),
                (197, (0, 1, 0)), (275, (2, 3, 0))),
          _sync((28, (0, 0, 0, 2, 2, 0)), (119, (0, 2, 0)),
                (197, (1, 3, 0)), (275, (2, 1, 3)))),
    data=_data((2, 26), (34, 85), (122, 75), (200, 75), (278, 70)),
)

# nb.c:294-325 (§7.4.11)
RACH = Burst(
    "rach", PI4CQPSK, 39 * 9, 494, 2, 3,
    sync=(_sync(
        (78, (0, 2, 2, 0, 0, 0, 2, 0, 2, 2, 2, 2, 2, 0, 2, 2, 0)),
        (127, (2,) * 32),
        (191, (2,) * 32),
        (255, (0, 2, 2, 0, 0, 0, 2, 0, 2, 2, 2, 2, 2, 0, 2, 2, 0)),
        (347, (0,)),
    ),),
    data=_data((2, 76), (95, 32), (159, 32), (223, 32), (272, 75)),
)

# nb.c:330-377 (§7.4.12) — four sync sequences, pi/4-CBPSK
SDCCH = Burst(
    "sdcch", PI4CBPSK, 39 * 6, 208, 2, 3,
    sync=(
        _sync((28, (0, 1, 0, 1, 0, 1, 0)), (115, (1, 0, 1, 0, 1, 0, 1)),
              (197, (0, 1, 0, 1, 0, 1, 1))),
        _sync((28, (0, 0, 1, 1, 0, 0, 1)), (115, (1, 0, 0, 1, 1, 0, 0)),
              (197, (1, 1, 0, 0, 1, 1, 1))),
        _sync((28, (0, 0, 0, 0, 1, 1, 1)), (115, (1, 0, 0, 0, 0, 1, 1)),
              (197, (1, 1, 0, 0, 0, 0, 1))),
        _sync((28, (0, 1, 1, 0, 1, 0, 0)), (115, (1, 0, 1, 1, 0, 1, 0)),
              (197, (0, 1, 0, 1, 1, 0, 1))),
    ),
    data=_data((2, 26), (35, 80), (122, 75), (204, 27)),
)

ALL_BURSTS = (BCCH, DC2, DC6, DC12, NT3_SPEECH, NT3_FACCH, NT6, NT9, RACH, SDCCH)
