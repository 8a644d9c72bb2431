"""analyze_reshard over a torch.distributed process group: 2 gloo CPU
processes, one time shard each, one all_to_all_single (model:
tests/test_distributed.py, the JAX multi-process mesh).

The parent computes the reference with JAX (gmr1_tpu.parallel.ingest's
analyze_reshard inside shard_map over 2 virtual CPU devices) and hands
it over as .npy files; the children import the port only (no JAX) and
hold their carrier rows against it: f32 transport at rtol 1e-4 / atol
1e-4, bf16 within one bf16 ulp (|a - b| <= 2^-7 |b| + 1e-6), and an
all_reduce checksum of |rows| against the reference's.
"""

import pathlib
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from gmr1_tpu.channelizer import Channelizer
from gmr1_tpu.parallel import ingest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FS, CENTER = 1e6, 1525e6 + 31250 * 512
D = 2

_CHILD = textwrap.dedent("""
    import sys
    root, port, rank, data = sys.argv[1], sys.argv[2], int(sys.argv[3]), \\
        sys.argv[4]
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from gmr1_tpu_torch.channelizer.pfb import Channelizer
    from gmr1_tpu_torch.parallel import analyze_reshard

    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + port,
                            world_size=2, rank=rank)
    ana = Channelizer(1e6, 1525e6 + 31250 * 512, sps=4).analyzer
    sh = np.load(data + "/shards.npy")
    ml = ana.m // 2
    for bf16 in (False, True):
        rows = analyze_reshard(ana, dist.group.WORLD,
                               torch.from_numpy(sh[rank]), bf16_reshard=bf16)
        want = np.load(data + f"/rows_{int(bf16)}.npy")[rank * ml:
                                                       (rank + 1) * ml]
        got = rows.numpy()
        assert got.shape == want.shape, (got.shape, want.shape)
        if bf16:
            bad = np.abs(got - want) > 2.0 ** -7 * np.abs(want) + 1e-6
            assert not bad.any(), int(bad.sum())
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        chk = torch.tensor([float(np.abs(got).astype(np.float64).sum())],
                           dtype=torch.float64)
        dist.all_reduce(chk)
        ref = float(np.abs(np.load(data + f"/rows_{int(bf16)}.npy"))
                    .astype(np.float64).sum())
        assert abs(float(chk) - ref) / ref < 1e-5, (float(chk), ref)
    dist.destroy_process_group()
    bad = sorted(k for k in sys.modules if k.split(".")[0] in
                 ("jax", "jaxlib", "gmr1_tpu"))
    assert not bad, bad
    print("DIST_OK", rank, flush=True)
""")


def test_two_process_group_reshard(tmp_path):
    ana = Channelizer(FS, CENTER, sps=4).analyzer
    halo, n_local = ana.p * ana.m, 32 * 64
    rng = np.random.default_rng(0xD15)
    x = rng.standard_normal((D * n_local, 2)).astype(np.float32)
    sh, _ = ingest.overlapped_shards(x, np.zeros((halo, 2), np.float32),
                                     halo, D)
    np.save(tmp_path / "shards.npy", np.asarray(sh))
    mesh = Mesh(np.array(jax.devices()[:D]), ("dev",))
    for bf16 in (False, True):
        f = jax.jit(jax.shard_map(
            lambda xh, b=bf16: ingest.analyze_reshard(ana, "dev", D, xh[0], b),
            mesh=mesh, in_specs=P("dev"), out_specs=P("dev")))
        np.save(tmp_path / f"rows_{int(bf16)}.npy",
                np.asarray(f(jnp.asarray(sh))))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(ROOT), port, str(i), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(tmp_path)) for i in range(D)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i} failed:\n{out[-3000:]}"
        assert f"DIST_OK {i}" in out, out[-3000:]
