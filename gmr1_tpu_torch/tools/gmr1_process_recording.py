"""Batch decode driver (reference utils/gmr1_process_recording.py;
counterpart of tools/gmr1_process_recording.py).

    python -m gmr1_tpu_torch.tools.gmr1_process_recording [--run] CAP.cfile...

Parses '-f<freq>-s<rate>-t<YYYYmmddHHMMSS>.cfile' capture names,
enumerates the visible ARFCNs, and prints (with --run also runs) the
split and demod commands of this package's CLIs:
`python -m gmr1_tpu_torch.channelizer ...` and
`python -m gmr1_tpu_torch.rx 4 arfcn_<a>.cfile` for every visible ARFCN.
"""

from __future__ import annotations

import datetime
import re
import subprocess
import sys
from collections import namedtuple

CHAN_BW = 31.25e3
N_ARFCNS = {"L": 1087, "S": 960}
BASE = {"L": 1525e6, "S": 2170e6 + 15.625e3}

Recording = namedtuple("Recording", "center samplerate timestamp")


def parse_filename(fn: str) -> Recording | None:
    m = re.match(r"^.*-f([0-9.e+-]*)-s([0-9.e+-]*)-t([0-9]{14})\.cfile$", fn)
    if not m:
        return None
    return Recording(
        float(m.group(1)), float(m.group(2)),
        datetime.datetime.strptime(m.group(3), "%Y%m%d%H%M%S"))


def arfcn_to_freq(arfcn: int, band: str = "L") -> float:
    return BASE[band] + CHAN_BW * arfcn


def visible_arfcns(p: Recording) -> tuple[str, list[int]]:
    ll = p.center - p.samplerate / 2 + CHAN_BW
    ul = p.center + p.samplerate / 2 - CHAN_BW
    band = "S" if ul > 2e9 else "L"
    vis = [a for a in range(N_ARFCNS[band] + 1)
           if ll <= arfcn_to_freq(a, band) <= ul]
    return band, vis


def commands(fn: str) -> list[list[str]] | None:
    """The split command and one demod command a visible ARFCN (None if
    the name does not parse)."""
    p = parse_filename(fn)
    if p is None:
        return None
    band, vis = visible_arfcns(p)
    split = [sys.executable, "-m", "gmr1_tpu_torch.channelizer", fn,
             "-s", f"{p.samplerate:f}", "-f", f"{p.center:f}", "-B", band]
    for a in vis:
        split += ["-a", str(a)]
    return [split] + [[sys.executable, "-m", "gmr1_tpu_torch.rx", "4",
                       f"arfcn_{a}.cfile"] for a in vis]


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    run = "--run" in args
    files = [a for a in args if not a.startswith("--")]
    if not files:
        print("Usage: python -m gmr1_tpu_torch.tools.gmr1_process_recording "
              "[--run] capture.cfile...", file=sys.stderr)
        return 1
    for fn in files:
        cmds = commands(fn)
        if cmds is None:
            print(f"[!] cannot parse {fn}", file=sys.stderr)
            continue
        for cmd in cmds:
            print(" ".join(cmd))
            if run:
                subprocess.run(cmd, check=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
