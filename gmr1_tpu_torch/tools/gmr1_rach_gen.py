"""RACH burst generator (reference src/gmr1_rach_gen.c; counterpart of
tools/gmr1_rach_gen.py).

    python -m gmr1_tpu_torch.tools.gmr1_rach_gen out.cfile SB_MASK PAYLOAD_36HEX \\
        [--device cuda|cpu]

Encodes an 18-byte RACH payload, modulates the RACH burst at 1 sps and
dumps it as a .cfile.  The coding and modulation run on the card unless
--device cpu.
"""

from __future__ import annotations

import argparse
import sys

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gmr1_tpu_torch.tools.gmr1_rach_gen")
    ap.add_argument("out")
    ap.add_argument("sb_mask", help="SB mask, e.g. 0x05")
    ap.add_argument("payload", help="18 bytes as 36 hex digits")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the coding (cuda or cpu)")
    args = ap.parse_args(argv)
    sb_mask = int(args.sb_mask, 0)
    payload = bytes.fromhex(args.payload)
    if len(payload) != 18:
        print("Invalid payload string", file=sys.stderr)
        return 1

    from .. import checked_device
    from ..l1 import rach
    from ..rx import cfile
    from ..sdr import bursts as BU
    from ..sdr import modem

    dev = checked_device(args.device)
    ebits = rach.encode(torch.tensor(list(payload), dtype=torch.uint8,
                                     device=dev), sb_mask)
    cfile.save(args.out, modem.mod(BU.RACH, ebits).cpu().numpy())
    return 0


if __name__ == "__main__":
    sys.exit(main())
