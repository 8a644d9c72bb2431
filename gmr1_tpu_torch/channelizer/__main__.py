"""Wideband splitter CLI (reference utils/gmr1_rx_sdr.py file mode;
counterpart of gmr1_tpu/channelizer/__main__.py).

    python -m gmr1_tpu_torch.channelizer wideband.cfile -s RATE -f CENTER \\
        -a ARFCN [-a ARFCN ...] [-o OUTDIR] [--sps 4] [-B L|S] \\
        [--mode pfb|direct] [--block N] [--device cuda|cpu]

Channelizes a wideband capture and writes one per-carrier .cfile (planar
float32) per requested channel, named arfcn_<id>.cfile after the
reference's FIFO convention (utils/gmr1_process_recording.py:57).  ARFCN
syntax supports widths ('510x3') and uplink ('U510').  The capture is cut
into --block samples and each block is channelized on its own, as in the
JAX CLI: no state crosses a block (Channelizer.process restarts its
rotation phase, DirectDDC its phasor).  The signal math runs on the card
unless --device cpu.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gmr1_tpu_torch.channelizer")
    ap.add_argument("capture")
    ap.add_argument("-s", "--samp-rate", type=float, required=True)
    ap.add_argument("-f", "--center-freq", type=float, required=True)
    ap.add_argument("-a", "--arfcn", action="append", required=True,
                    help="channel spec, e.g. 510, 510x3, U510 (repeatable)")
    ap.add_argument("-B", "--band", choices=("L", "S"), default="L")
    ap.add_argument("-o", "--outdir", default=".")
    ap.add_argument("--sps", type=int, default=4)
    ap.add_argument("--mode", choices=("pfb", "direct"), default="pfb",
                    help="polyphase channelizer or per-carrier DDC chains")
    ap.add_argument("--block", type=int, default=1 << 22,
                    help="wideband samples per processing block")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the signal math (cuda or cpu)")
    args = ap.parse_args(argv)

    from .. import checked_device
    from ..rx.cfile import CFile
    from .arfcn import Channel
    from .ddc import DirectDDC, DirectParams
    from .pfb import Channelizer

    dev = checked_device(args.device)
    chans = [Channel.parse(a, args.band) for a in args.arfcn]
    need_nx = any(c.width > 1 for c in chans)
    if args.mode == "pfb":
        chz = Channelizer(args.samp_rate, args.center_freq, sps=args.sps,
                          need_nx=need_nx)
    else:
        ddcs = {str(c): DirectDDC(DirectParams(args.samp_rate, c.symbol_rate,
                                               args.sps),
                                  c.frequency - args.center_freq)
                for c in chans}

    cf = CFile(args.capture)
    outs = {}
    for c in chans:
        path = os.path.join(args.outdir, f"arfcn_{c.arfcn}.cfile")
        outs[str(c)] = open(path, "wb")

    n = len(cf)
    try:
        for beg in range(0, n, args.block):
            blk = torch.from_numpy(np.array(
                cf.data[beg:min(beg + args.block, n)], np.float32)).to(dev)
            bank = chz.process(blk) if args.mode == "pfb" else None
            for c in chans:
                if args.mode == "pfb":
                    stream = chz.extract(bank, c)
                else:
                    stream = ddcs[str(c)](blk)
                if stream is None:
                    print(f"[!] {c} outside capture bandwidth",
                          file=sys.stderr)
                    continue
                stream.cpu().numpy().astype(np.float32).tofile(outs[str(c)])
    finally:
        for fh in outs.values():
            fh.close()
    print(f"[+] wrote {len(outs)} carrier streams to {args.outdir}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
