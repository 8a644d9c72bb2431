"""pre-resampler: the bound of the resampling the profiled stretch's
blocks needed (one block a `rx.pre` range) over the device time of the
kernels launched inside those ranges, %.

The work is the resampler's, counted from the configuration and the
geometry of pre.py's taps, not from the program, so it reads the same
whatever implements it: the capture at fs lands on the grid at n_chans x
31.25 kHz, ratio num / den; a block makes n_out = block_frames x 2500 x
n_chans / 2 outputs, each of two components, each a sum of tpb + 1 raw
samples, one weight a sample (pre.resample blends two adjacent branches,
which fold into one weight, as in the program's period matrix): tpb + 1
multiply-adds, 2 (tpb + 1) operations, a component.  The block's raw samples (n_out den / num,
and the tpb before them) are read once, the L x tpb taps once, and the
outputs written once, complex64."""

from portbench import pre, rrc, work


def resample(fs: float, m: int, block_frames: int) -> tuple[float, float]:
    """(bytes, operations) of one block's resampling."""
    r = pre.ratio(fs, m)
    tpb = -(-len(pre.taps(r)) // rrc.L)
    n_out = block_frames * 2500 * (m // 2)
    n_in = -(-n_out * r.denominator // r.numerator) + tpb
    nbytes = 8.0 * n_in + 4.0 * rrc.L * tpb + 8.0 * n_out
    return nbytes, n_out * 2 * 2.0 * (tpb + 1)


def read(ctx):
    rx = (ctx.get("trace") or {}).get("rx") or {}
    blocks = sum(1 for name, _a, _b in rx.get("ranges", ())
                 if name == "pre")
    sec = rx.get("device_s", {}).get("pre", 0.0)
    if not blocks or not sec:
        return None
    cfg = ctx["cfg"]
    nbytes, nops = resample(cfg["fs"], cfg["n_chans"], cfg["block_frames"])
    return 100.0 * blocks * work.bound_s(nbytes, nops) / sec
