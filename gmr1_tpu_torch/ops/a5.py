"""GMR-1 A5 ciphering (reference src/l1/a5.c, after Driessen et al.).

Counterpart of gmr1_tpu/ops/a5.py.  A5/0 is the null cipher; A5/1 is a
4-LFSR (19/22/23-bit output registers plus a 17-bit clock-control
register R4) majority-clocked generator with a majority-of-taps output
filter.  The key schedule byte-swaps the SIM key and mixes the frame
number into key bytes 0, 1, 3 and 6 (a5.c:233-241), then runs 64 forced
clocks injecting key bits, sets the LSB of each register, and mixes 250
clocks before output.

Three implementations:
  * keystream_np     plain NumPy, one (key, fn) at a time; the
                     reference-exact transcription of a5.c that the tests
                     and the card check hold the others to.
  * keystream_plain  batched PyTorch over frame numbers: the 314 + 2*nbits
                     dependent clocks as a Python loop of tensor ops.  The
                     registers are held in int64 (they are 17-23 bits
                     wide; torch's uint32 supports few operations).
  * the CUDA kernel  kernels/a5.cu: the key schedule in closed form (the
                     host's base state XOR per-fn-bit deltas), four lanes
                     a frame number (R1, R2, R3 each as a window of its
                     bit stream, R4's clock decisions 32 steps at a
                     time), rows written as whole lines.
`keystream` dispatches by device: a CUDA tensor of frame numbers runs
the kernel, a CPU tensor the plain version; nothing falls back.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels

_LENS = (19, 22, 23, 17)
_MASKS = tuple((1 << l) - 1 for l in _LENS)
# Feedback tap masks (a5.c:129-132)
_TAPS = (0x072000, 0x311000, 0x660000, 0x013100)
# R4 clock-control bit positions (a5.c:169-171)
_R4_CB = (15, 6, 1)
# Output filter: majority over 3 taps per register, XOR one extra tap
_OUT_MAJ = ((1, 6, 15), (3, 8, 14), (4, 15, 19))
_OUT_XOR = (11, 1, 0)
_KEY_SWAP = [1, 0, 3, 2, 5, 4, 7, 6]


def _parity32(x):
    x ^= x >> 16
    x ^= x >> 8
    x ^= x >> 4
    x ^= x >> 2
    x ^= x >> 1
    return x & 1


def _mix_key(key, fn: int) -> np.ndarray:
    lkey = np.asarray(key, dtype=np.uint8)[_KEY_SWAP].copy()
    lkey[6] ^= (fn & 0x0000F) << 4
    lkey[3] ^= (fn & 0x00030) << 2
    lkey[1] ^= (fn & 0x007C0) >> 3
    lkey[0] ^= (fn & 0x0F800) >> 11
    lkey[0] ^= (fn & 0x70000) >> 11
    return lkey


def keystream_np(key, fn: int, nbits: int) -> tuple[np.ndarray, np.ndarray]:
    """Reference-exact A5/1: returns (dl, ul) hard-bit arrays."""
    lkey = _mix_key(key, fn)
    r = [0, 0, 0, 0]

    def clock_one(i):
        r[i] = ((r[i] << 1) & _MASKS[i]) | _parity32(r[i] & _TAPS[i])

    def clock_all():
        cb = [(r[3] >> b) & 1 for b in _R4_CB]
        m = int(sum(cb) >= 2)
        for i in range(3):
            if cb[i] == m:
                clock_one(i)
        clock_one(3)

    for i in range(64):
        b = (int(lkey[i >> 3]) >> (7 - (i & 7))) & 1
        for j in range(4):
            clock_one(j)
        for j in range(4):
            r[j] ^= b
    for j in range(4):
        r[j] |= 1
    for _ in range(250):
        clock_all()

    def output():
        v = 0
        for i in range(3):
            a, b, c = _OUT_MAJ[i]
            maj = int(((r[i] >> a) & 1) + ((r[i] >> b) & 1)
                      + ((r[i] >> c) & 1) >= 2)
            v ^= maj ^ ((r[i] >> _OUT_XOR[i]) & 1)
        return v

    dl = np.empty(nbits, dtype=np.uint8)
    ul = np.empty(nbits, dtype=np.uint8)
    for i in range(nbits):
        clock_all()
        dl[i] = output()
    for i in range(nbits):
        clock_all()
        ul[i] = output()
    return dl, ul


# --- batched PyTorch version ------------------------------------------------

def _key_bytes(key) -> np.ndarray:
    """The 8-byte SIM key as a host uint8 array."""
    if isinstance(key, torch.Tensor):
        key = key.cpu().numpy()
    key = np.asarray(key, np.uint8).reshape(8)
    return key


def _tparity(x):
    for s in (16, 8, 4, 2, 1):
        x = x ^ (x >> s)
    return x & 1


def _tclock_forced(r, masks, taps):
    return ((r << 1) & masks) | _tparity(r & taps)


def _tclock(r, masks, taps):
    r4 = r[..., 3]
    cb = [(r4 >> b) & 1 for b in _R4_CB]
    m = ((cb[0] + cb[1] + cb[2]) >= 2).to(r.dtype)
    gate = torch.stack([cb[0] == m, cb[1] == m, cb[2] == m,
                        torch.ones_like(m, dtype=torch.bool)], dim=-1)
    return torch.where(gate, _tclock_forced(r, masks, taps), r)


def _toutput(r):
    v = torch.zeros(r.shape[:-1], dtype=r.dtype, device=r.device)
    for i in range(3):
        a, b, c = _OUT_MAJ[i]
        ri = r[..., i]
        s = ((ri >> a) & 1) + ((ri >> b) & 1) + ((ri >> c) & 1)
        v = v ^ (s >= 2).to(r.dtype) ^ ((ri >> _OUT_XOR[i]) & 1)
    return v.to(torch.uint8)


def _mixed_keys(key, fns):
    """(..., 8) int64 per-fn key bytes after the frame-number mix."""
    k = torch.as_tensor(_key_bytes(key)[_KEY_SWAP].astype(np.int64),
                        device=fns.device)
    lkey = k.expand(*fns.shape, 8).clone()
    lkey[..., 0] ^= ((fns & 0x0F800) >> 11) ^ ((fns & 0x70000) >> 11)
    lkey[..., 1] ^= (fns & 0x007C0) >> 3
    lkey[..., 3] ^= (fns & 0x00030) << 2
    lkey[..., 6] ^= (fns & 0x0000F) << 4
    return lkey


def keystream_plain(key, fns, nbits: int, with_ul: bool = True):
    """Batched A5/1 in plain PyTorch: key (8,) uint8, fns (...,) integer
    frame numbers -> (dl, ul), each (..., nbits) uint8 (ul is None when
    `with_ul` is False).  All frame numbers share the key, as in the
    receiver (gmr1_rx.c:407,518)."""
    fns = torch.as_tensor(fns).to(torch.int64)
    dev = fns.device
    masks = torch.as_tensor(_MASKS, dtype=torch.int64, device=dev)
    taps = torch.as_tensor(_TAPS, dtype=torch.int64, device=dev)
    lkey = _mixed_keys(key, fns)
    r = torch.zeros((*fns.shape, 4), dtype=torch.int64, device=dev)
    for i in range(64):
        b = (lkey[..., i >> 3] >> (7 - (i & 7))) & 1
        r = _tclock_forced(r, masks, taps) ^ b[..., None]
    r = r | 1
    for _ in range(250):
        r = _tclock(r, masks, taps)

    def gen(r):
        out = []
        for _ in range(nbits):
            r = _tclock(r, masks, taps)
            out.append(_toutput(r))
        return r, torch.stack(out, dim=-1)

    r, dl = gen(r)
    ul = gen(r)[1] if with_ul else None
    return dl, ul


def _keystream_cuda(key, fns, nbits: int, with_ul: bool = True):
    """Launch kernels/a5.cu on a CUDA tensor of frame numbers (raises on
    anything else)."""
    if not fns.is_cuda:
        raise ValueError("the A5 kernel takes a CUDA tensor of frame numbers")
    if fns.dtype != torch.int64:
        raise TypeError("the A5 kernel takes int64 frame numbers")
    if nbits < 1:
        raise ValueError(f"nbits must be positive, got {nbits}")
    flat = fns.reshape(-1).contiguous()
    b_cnt = flat.shape[0]
    k = _key_bytes(key)
    key_word = int(np.frombuffer(k.tobytes(), "<u8")[0])
    dl = torch.empty((b_cnt, nbits), dtype=torch.uint8, device=fns.device)
    ul = torch.empty_like(dl) if with_ul else None
    kernels.launch("a5", fns.device, key_word, flat.data_ptr(),
                   dl.data_ptr(), ul.data_ptr() if with_ul else None, b_cnt,
                   nbits)
    keystream.launches += 1
    shape = (*fns.shape, nbits)
    return dl.view(shape), ul.view(shape) if with_ul else None


def keystream(key, fns, nbits: int, with_ul: bool = True):
    """Batched A5/1: key (8,) uint8, fns (...,) int64 -> (dl, ul) of
    (..., nbits) uint8.  The CUDA kernel for CUDA frame numbers, the
    plain version for CPU ones.  `with_ul=False` skips the uplink half
    (ul is then None); the receiver uses only dl."""
    fns = torch.as_tensor(fns)
    if fns.is_cuda:
        return _keystream_cuda(key, fns.to(torch.int64), nbits, with_ul)
    if fns.device.type != "cpu":
        raise ValueError(f"no A5 generator for device {fns.device}")
    return keystream_plain(key, fns, nbits, with_ul)


keystream.launches = 0     # kernel launches (CUDA path only)


def cipher_stream(n: int, key, fns, nbits: int):
    """gmr1_a5 equivalent: n=0 -> zeros, n=1 -> A5/1 (a5.c:57-77)."""
    if n == 0:
        fns = torch.as_tensor(fns)
        z = torch.zeros((*fns.shape, nbits), dtype=torch.uint8,
                        device=fns.device)
        return z, z
    if n == 1:
        return keystream(key, fns, nbits)
    raise ValueError(f"A5/{n} not defined for GMR-1")
