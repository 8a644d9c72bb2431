"""AMBE decoder CLI (reference src/gmr1_ambe_decode.c; counterpart of
gmr1_tpu/codec/__main__.py).

    python -m gmr1_tpu_torch.codec [in_file [out_file]] [--device cuda|cpu]

Reads a stream of 10-byte AMBE frames, writes 8 kHz s16le PCM; a .wav
output path gets a WAV header.  '-' = stdin/stdout.  The decoder runs on
the card unless --device cpu is given (without CUDA the default raises).
"""

from __future__ import annotations

import argparse
import struct
import sys

import numpy as np


def wav_header(n_samples: int) -> bytes:
    """8 kHz mono s16 WAV header (gmr1_ambe_decode.c:26-45)."""
    data = n_samples * 2
    return (b"RIFF" + struct.pack("<I", 36 + data) + b"WAVEfmt "
            + struct.pack("<IHHIIHH", 16, 1, 1, 8000, 16000, 2, 16)
            + b"data" + struct.pack("<I", data))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="gmr1_tpu_torch.codec",
        description="AMBE decoder: 10-byte frames -> 8 kHz s16le PCM")
    ap.add_argument("files", nargs="*", metavar="in_file [out_file]",
                    help="input frames and output PCM ('-' = stdin/stdout; "
                         "a .wav output gets a header)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the decoder (cuda or cpu)")
    args = ap.parse_args(argv)
    if len(args.files) > 2:
        ap.print_usage(sys.stderr)
        return 1
    from . import decode_frames, init
    state = init((), device=args.device)     # raises without CUDA

    files = args.files
    fin = sys.stdin.buffer if not files or files[0] == "-" else \
        open(files[0], "rb")
    with fin:
        raw = fin.read()
    n = len(raw) // 10
    if not n:
        return 0
    frames = np.frombuffer(bytearray(raw[:n * 10]), np.uint8).reshape(n, 10)
    _, pcm = decode_frames(state, frames)
    pcm = pcm.cpu().numpy().astype("<i2").reshape(-1)

    is_wave = len(files) > 1 and files[1].endswith(".wav")
    fout = sys.stdout.buffer if len(files) < 2 or files[1] == "-" else \
        open(files[1], "wb")
    try:
        if is_wave:
            fout.write(wav_header(len(pcm)))
        fout.write(pcm.tobytes())
        fout.flush()
    finally:
        if fout is not sys.stdout.buffer:
            fout.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
