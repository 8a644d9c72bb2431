"""GMR-1 channel grid model (reference utils/gmr1_rx_sdr.py:71-171).

ARFCN <-> frequency for L-band and S-band, up/downlink, carrier widths
1/2/3/5 x 31.25 kHz.  Pure host-side data math.
"""

from __future__ import annotations

from dataclasses import dataclass

BASE_BANDWIDTH = 31.25e3
BASE_SYMRATE = 23.4e3

_BASES = {
    ("L", False): 1525e6,             # L-band downlink
    ("L", True): 1626.5e6,            # L-band uplink
    ("S", False): 2170e6 + 15.625e3,  # S-band downlink
    ("S", True): 1980e6 + 15.625e3,   # S-band uplink
}


@dataclass(frozen=True)
class Channel:
    arfcn: int
    width: int = 1
    uplink: bool = False
    band: str = "L"

    def __post_init__(self):
        if self.width not in (1, 2, 3, 5):
            raise ValueError("Invalid channel width")
        if self.band not in ("L", "S"):
            raise ValueError("Invalid frequency band")

    @classmethod
    def parse(cls, s: str, band: str = "L") -> "Channel":
        """'U123x3' -> uplink ARFCN 123 width 3 (reference :82-91)."""
        uplink = s.startswith("U")
        if uplink:
            s = s[1:]
        width = 1
        if "x" in s:
            s, w = s.split("x")
            width = int(w)
        return cls(int(s), width, uplink, band)

    def __str__(self) -> str:
        return "%s%d%s" % ("U" if self.uplink else "", self.arfcn,
                           "x%d" % self.width if self.width > 1 else "")

    @property
    def base_freq(self) -> float:
        return _BASES[(self.band, self.uplink)]

    @property
    def frequency(self) -> float:
        """Carrier center (reference :138-140): odd widths sit on the
        grid line, even widths half a channel up."""
        return self.base_freq + BASE_BANDWIDTH * (
            self.arfcn + 0.5 * ((self.width ^ 1) & 1))

    @property
    def bandwidth(self) -> float:
        return BASE_BANDWIDTH * self.width

    @property
    def symbol_rate(self) -> float:
        return BASE_SYMRATE * self.width

    @property
    def arfcns(self) -> list[int]:
        """Sub-carrier ARFCNs spanned by a wide channel (:126-129)."""
        return list(range(self.arfcn - (self.width - 1) // 2,
                          self.arfcn + (self.width + 2) // 2))

    @property
    def subchannels(self) -> list["Channel"]:
        return [Channel(a, 1, self.uplink, self.band) for a in self.arfcns]


def align_freq(freq: float) -> float:
    """Snap a tuner frequency to the nearest grid line (:160-169)."""
    base = min(_BASES.values(), key=lambda b: abs(b - freq))
    chan = round((freq - base) / BASE_BANDWIDTH)
    return base + chan * BASE_BANDWIDTH
