"""channel DFT: the bound of the products of the profiled stretch's
blocks (work.dft_block, bf16 operations at 989 TFLOP/s; one product a
kernel P launch) over the device time of the kernels launched inside the
pb.dft span (the cast of the activation and the product), %."""

from portbench import work


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["families"]["DFT"][1] or not tr["families"]["P"][1]:
        return None
    cfg = ctx["cfg"]
    nbytes, nops = work.dft_block(cfg["n_chans"], cfg["block_frames"] * 2500)
    calls = tr["families"]["P"][1]
    return 100.0 * calls * work.bound_s(nbytes, nops, work.BF16_FLOPS) \
        / tr["families"]["DFT"][0]
