"""The work counts against hand sums."""

from portbench import work


def test_pfb_block():
    # M = 1088 (hop 544), P = 10, 20000 rows: the hop-row view
    # (20020 x 544 x 2 floats), the 42 x 544 weights, the 20000 x 2176
    # activation, 4 bytes each; 20000 x 544 x 4 x 10 x 2 operations
    nbytes, nops = work.pfb_block(1088, 10, 20000)
    assert nbytes == 4 * (20020 * 544 * 2 + 42 * 544 + 20000 * 2176)
    assert nops == 20000 * 544 * 80
    assert abs(work.bound_s(nbytes, nops) - nbytes / 3.35e12) < 1e-15


def test_dft_block():
    nbytes, nops = work.dft_block(1088, 20000)
    assert nbytes == 4 * 20000 * 2176 * 2 + 2 * 2176 * 2176
    assert nops == 2 * 20000 * 2176 * 2176
    assert work.bound_s(nbytes, nops, work.BF16_FLOPS) == nops / 989e12


def test_viterbi():
    # one BCCH burst: 212 steps of 16 states, r = 1/2; one speech burst:
    # two 48-step, 64-state trellises
    nbytes, nops = work.viterbi({"bcch": 1, "speech": 1})
    assert nbytes == (212 * 9 + 4) + 2 * (48 * 9 + 4)
    assert nops == 212 * (48 + 16) + 2 * 48 * (192 + 16)
