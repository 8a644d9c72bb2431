"""kernel P: the bound of the blocks it analysed in the profiled stretch
(work.pfb_block at the configuration's M, P and block rows, one a launch)
over its device time there, %."""

from portbench import work


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["families"]["P"][1]:
        return None
    sec, launches = tr["families"]["P"]
    cfg = ctx["cfg"]
    rows = cfg["block_frames"] * 2500
    nbytes, nops = work.pfb_block(cfg["n_chans"], cfg["taps_per_branch"],
                                  rows)
    return 100.0 * launches * work.bound_s(nbytes, nops) / sec
