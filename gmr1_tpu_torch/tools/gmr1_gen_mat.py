"""FACCH3 generator-matrix probe (reference src/gmr1_gen_mat.c;
counterpart of tools/gmr1_gen_mat.py).

    python -m gmr1_tpu_torch.tools.gmr1_gen_mat [--device cuda|cpu]

Derives the code's generator matrix G and offset g by encoding unit
vectors (a linearity self-check of the encode chain, all 77 messages in
one batch on the card unless --device cpu) and writes mat_G.pbm /
mat_g.pbm in the current directory.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def nonstatus_bits(ebits: np.ndarray) -> np.ndarray:
    """(..., 416) burst bits -> (..., 384), dropping the 8 status bits at
    22..29 of each 104-bit burst (gmr1_gen_mat.c copy_bits)."""
    e = ebits.reshape(*ebits.shape[:-1], 4, 104)
    return np.concatenate([e[..., :22], e[..., 30:]], axis=-1).reshape(
        *ebits.shape[:-1], 384)


def pbm_save(filename: str, m: np.ndarray) -> None:
    with open(filename, "w") as fh:
        fh.write(f"P1\n{m.shape[1]} {m.shape[0]}\n")
        for row in m:
            fh.write(" ".join(str(int(v)) for v in row) + "\n")


def generator(device) -> tuple[np.ndarray, np.ndarray]:
    """(G (384, 76), g (384,)): encode(u) = G @ u ^ g over GF(2)."""
    from ..l1 import facch3
    from ..ops import bits as B
    u = np.concatenate([np.zeros((1, 76), np.uint8),
                        np.eye(76, dtype=np.uint8)])          # (77, 76)
    l2 = B.pack_bits(torch.as_tensor(u, device=device), 10)
    e = facch3.encode(l2, torch.zeros((77, 32), dtype=torch.uint8,
                                      device=device))
    enc = nonstatus_bits(e.cpu().numpy().astype(np.uint8))     # (77, 384)
    g = enc[0]
    return (enc[1:] ^ g).T.copy(), g


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gmr1_tpu_torch.tools.gmr1_gen_mat")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the encoder (cuda or cpu)")
    args = ap.parse_args(argv)
    from .. import checked_device
    G, g = generator(checked_device(args.device))
    pbm_save("mat_G.pbm", G)
    pbm_save("mat_g.pbm", g[:, None])
    print("wrote mat_G.pbm (384x76), mat_g.pbm (384x1)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
