"""Receiver CLI (reference src/gmr1_rx.c:913 usage; counterpart of
gmr1_tpu/rx/__main__.py).

Per-carrier mode (one pre-channelized capture, like the reference):

    python -m gmr1_tpu_torch.rx SPS BCCH.cfile [TCH.cfile [KEYHEX [TCH_CSD.cfile]]]

Wideband mode (one raw wideband capture; channelize + decode every
carrier in batched device calls):

    python -m gmr1_tpu_torch.rx --wideband CAP.cfile|tcp://HOST:PORT \\
        --fs HZ --center HZ [--arfcns 970,974] [--snr-min 3] [--beams 2] \\
        [--wide ARFCNxW ...] [--stream] [--h2d-dtype int16] [--key KEYHEX]

Options: --device cuda|cpu (where the signal math runs; cuda by default,
and an error where CUDA is absent), --pcap FILE (also write GSMTap to
pcap), --no-udp, --csd-out FILE, --speech-out FILE, --fcch3-l,
--fcch3-s (FCCH3 burst variants), -v.
"""

from __future__ import annotations

import argparse
import sys

from ..channelizer.arfcn import Channel
from ..sdr import fcch
from . import CFile, GsmtapSink, Receiver


def _dump(path: str | None, chunks) -> None:
    """Append decoded payload blocks to a file (gmr1_rx.c:342-347)."""
    if path and chunks:
        with open(path, "ab") as f:
            for c in chunks:
                f.write(c)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="gmr1_tpu_torch.rx",
        description="GMR-1 receiver: BCCH/CCCH/TCH3/TCH9 from cfile captures")
    ap.add_argument("sps", type=int, nargs="?")
    ap.add_argument("bcch", nargs="?")
    ap.add_argument("tch", nargs="?")
    ap.add_argument("key", nargs="?", help="A5 key (16 hex digits)")
    ap.add_argument("tch_csd", nargs="?")
    ap.add_argument("--wideband", metavar="CAP",
                    help="raw wideband capture (or tcp://host:port); "
                         "decode every carrier")
    ap.add_argument("--fs", type=float, help="wideband sample rate (Hz)")
    ap.add_argument("--center", type=float,
                    help="wideband center frequency (Hz)")
    ap.add_argument("--arfcns", help="comma list restricting the scan")
    ap.add_argument("--snr-min", type=float, default=2.0,
                    help="FCCH SNR gate for carrier activation")
    ap.add_argument("--beams", type=int, default=1,
                    help="FCCH beams per carrier (multi-beam scan)")
    ap.add_argument("--wide", action="append", default=[],
                    help="wide carrier spec like 500x3 (repeatable)")
    ap.add_argument("--h2d-dtype", choices=("float32", "int16"),
                    default="float32",
                    help="wideband ingest transfer dtype (int16: per-block "
                         "peak-normalized, half the upload; on-grid fs only)")
    ap.add_argument("--stream", action="store_true",
                    help="consume the capture strictly forward in "
                         "blocks (live-source mode; off-grid fs "
                         "resamples per block)")
    ap.add_argument("--csd-out", metavar="FILE",
                    help="append decoded TCH9 CSD payloads (the "
                         "reference's /tmp/csd.data, gmr1_rx.c:342)")
    ap.add_argument("--speech-out", metavar="FILE",
                    help="append decoded 10-byte TCH3 vocoder frames "
                         "(feed to python -m gmr1_tpu_torch.codec)")
    ap.add_argument("--key", dest="key_opt", help="A5 key (16 hex digits)")
    ap.add_argument("--sps", dest="sps_opt", type=int, default=4)
    ap.add_argument("--pcap", help="write GSMTap stream to a pcap file")
    ap.add_argument("--no-udp", action="store_true")
    ap.add_argument("--fcch3-l", action="store_true",
                    help="use FCCH3 L-band burst")
    ap.add_argument("--fcch3-s", action="store_true",
                    help="use FCCH3 S-band burst")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the signal math (cuda or cpu)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    ft = fcch.FCCH
    if args.fcch3_l:
        ft = fcch.FCCH3_LBAND
    if args.fcch3_s:
        ft = fcch.FCCH3_SBAND

    if args.wideband:
        if args.fs is None or args.center is None:
            print("[!] --wideband needs --fs and --center", file=sys.stderr)
            return 1
        kc = bytes.fromhex(args.key_opt) if args.key_opt else None
        if kc is not None and len(kc) != 8:
            print("[!] Invalid key", file=sys.stderr)
            return 1
        arfcns = [int(a) for a in args.arfcns.split(",")] \
            if args.arfcns else None
        from .cfile import CFileSource, SocketSource
        from .wideband import WidebandReceiver
        if args.wideband.startswith("tcp://"):      # live IQ server
            spec = args.wideband[6:]
            host, sep, port = spec.rpartition(":")
            if not sep or not port.isdigit():
                print("[!] tcp:// source needs host:port "
                      f"(got {args.wideband!r})", file=sys.stderr)
                return 1
            # bracketed IPv6 literal: tcp://[::1]:4729
            if host.startswith("[") and host.endswith("]"):
                host = host[1:-1]
            src = SocketSource(host, int(port))
        elif args.stream:
            src = CFileSource(args.wideband)
        else:
            src = CFile(args.wideband).data
        sink = GsmtapSink(host=None if args.no_udp else "127.0.0.1",
                          pcap_path=args.pcap)
        try:
            rx = WidebandReceiver(
                src, args.fs, args.center,
                sps=args.sps_opt, kc=kc, sink=sink, arfcns=arfcns,
                snr_min=args.snr_min, fcch_type=ft, verbose=args.verbose,
                beams=args.beams, h2d_dtype=args.h2d_dtype,
                wide_channels=[Channel.parse(s) for s in args.wide],
                device=args.device)
            n = rx.run()
        finally:
            sink.close()
            if isinstance(src, SocketSource):
                src.close()
        cars = rx.carriers + rx.wide_carriers
        per = ", ".join(f"{c.arfcn}:{len(c.frames)}" for c in cars
                        if c.frames)
        print(f"[+] {n} L2 frames decoded across "
              f"{len(cars)} carriers ({per})", file=sys.stderr)
        _dump(args.csd_out, [b for c in cars for b in c.csd])
        _dump(args.speech_out, [b for c in cars for b in c.speech])
        return 0

    if args.sps is None or args.bcch is None:
        ap.print_usage(sys.stderr)
        return 1
    if not 1 <= args.sps <= 16:
        print("[!] sps must be within [1,16]", file=sys.stderr)
        return 1

    kc = bytes.fromhex(args.key) if args.key else None
    if kc is not None and len(kc) != 8:
        print("[!] Invalid key", file=sys.stderr)
        return 1

    sink = GsmtapSink(host=None if args.no_udp else "127.0.0.1",
                      pcap_path=args.pcap)
    try:
        rx = Receiver(
            CFile(args.bcch), args.sps,
            tch_file=CFile(args.tch) if args.tch else None,
            kc=kc,
            tch_csd_file=CFile(args.tch_csd) if args.tch_csd else None,
            sink=sink, fcch_type=ft, verbose=args.verbose,
            device=args.device)
        n = rx.run()
    finally:
        sink.close()
    print(f"[+] {n} L2 frames decoded "
          f"({len(rx.speech)} speech, {len(rx.csd)} CSD blocks)",
          file=sys.stderr)
    _dump(args.csd_out, rx.csd)
    _dump(args.speech_out, rx.speech)
    return 0


if __name__ == "__main__":
    sys.exit(main())
