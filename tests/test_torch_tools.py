"""The command-line drivers, ported (gmr1_tpu_torch.tools), against the
repo's JAX tools (tools/gmr1_*.py) on the same inputs, mirroring
tests/test_tools.py:24,35,70:

  * gmr1_rach_gen: 351 unit-magnitude RACH symbols, each within 2 ulp of
    the JAX tool's cfile (float32 sin/cos round differently);
  * gmr1_gen_mat: G and g exactly equal to the JAX tool's pbm files, and
    G @ u ^ g equal to the port's encoder for a random message;
  * gmr1_process_recording: the same visible ARFCNs, with the port's
    module names in the commands.
"""

import sys

import numpy as np
import torch

from gmr1_tpu_torch.l1 import facch3
from gmr1_tpu_torch.ops import bits as B
from gmr1_tpu_torch.tools import gmr1_gen_mat, gmr1_process_recording
from gmr1_tpu_torch.tools import gmr1_rach_gen

torch.set_num_threads(2)


def _pbm(path):
    with open(path) as fh:
        assert fh.readline().strip() == "P1"
        w, h = map(int, fh.readline().split())
        m = np.array([line.split() for line in fh], np.uint8)
    assert m.shape == (h, w)
    return m


def test_rach_gen(tmp_path, rng, monkeypatch):
    from tools import gmr1_rach_gen as j_tool
    payload = bytes(rng.integers(0, 256, 18, dtype=np.uint8)).hex()
    out_j, out_t = tmp_path / "j.cfile", tmp_path / "t.cfile"
    monkeypatch.setattr(sys, "argv", ["gmr1_rach_gen.py", str(out_j), "0x05",
                                      payload])
    assert j_tool.main() == 0
    assert gmr1_rach_gen.main([str(out_t), "0x05", payload,
                               "--device", "cpu"]) == 0
    data = np.fromfile(out_t, np.complex64)
    assert len(data) == 351                     # RACH burst symbols
    assert np.allclose(np.abs(data[3:-3]), 1.0, atol=1e-5)
    np.testing.assert_array_max_ulp(np.fromfile(out_t, np.float32),
                                    np.fromfile(out_j, np.float32), maxulp=2)
    assert gmr1_rach_gen.main([str(out_t), "0x05", "00",
                               "--device", "cpu"]) == 1


def test_gen_mat(tmp_path, rng, monkeypatch):
    from tools import gmr1_gen_mat as j_tool
    for side in ("j", "t"):
        (tmp_path / side).mkdir()
    monkeypatch.chdir(tmp_path / "j")
    assert j_tool.main() == 0
    monkeypatch.chdir(tmp_path / "t")
    assert gmr1_gen_mat.main(["--device", "cpu"]) == 0
    G, g = _pbm(tmp_path / "t" / "mat_G.pbm"), _pbm(tmp_path / "t" / "mat_g.pbm")
    assert G.shape == (384, 76) and g.shape == (384, 1)
    np.testing.assert_array_equal(G, _pbm(tmp_path / "j" / "mat_G.pbm"))
    np.testing.assert_array_equal(g, _pbm(tmp_path / "j" / "mat_g.pbm"))
    # linearity check: enc(u) == G@u ^ g for a random message
    u = rng.integers(0, 2, 76).astype(np.uint8)
    e = facch3.encode(B.pack_bits(torch.as_tensor(u), 10),
                      torch.zeros(32, dtype=torch.uint8)).numpy()
    np.testing.assert_array_equal((G @ u + g[:, 0]) % 2,
                                  gmr1_gen_mat.nonstatus_bits(e))


def test_process_recording_driver(capsys):
    from tools import gmr1_process_recording as j_tool
    name = "cap-f1545000000-s4000000-t20240101120000.cfile"
    p = gmr1_process_recording.parse_filename(name)
    assert p == j_tool.parse_filename(name)
    assert p.center == 1545e6 and p.samplerate == 4e6
    band, vis = gmr1_process_recording.visible_arfcns(p)
    assert (band, vis) == j_tool.visible_arfcns(p)
    assert band == "L" and 100 <= len(vis) <= 130
    assert gmr1_process_recording.parse_filename("x.cfile") is None
    assert gmr1_process_recording.main([name]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 + len(vis)
    assert " -m gmr1_tpu_torch.channelizer " + name in lines[0]
    assert lines[0].count(" -a ") == len(vis)
    assert all(f" -m gmr1_tpu_torch.rx 4 arfcn_{a}.cfile" in line
               for a, line in zip(vis, lines[1:]))
    assert "gmr1_tpu." not in "".join(lines)
