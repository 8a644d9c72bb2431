"""Planar complex arithmetic: float32 tensors with a trailing (re, im) axis.

Counterpart of gmr1_tpu/ops/cplx.py.  Module boundaries keep the planar
(..., 2) layout one for one with the JAX package, so both take the same
arrays; on the card the layout is memory-identical to complex64.

Convention: x[..., 0] = real, x[..., 1] = imag, dtype float32.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import consts

# every float32 matrix product here must be real float32 (TF32 keeps
# about three decimal digits, the CUDA form of the XLA default-precision
# trap noted at gmr1_tpu/channelizer/pfb.py:75-78)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def tensor(x) -> torch.Tensor:
    """float32 tensor from an array-like (no copy if already one)."""
    if isinstance(x, torch.Tensor):
        return x if x.dtype == torch.float32 else x.float()
    return torch.as_tensor(np.asarray(x, np.float32))


def from_complex(x) -> torch.Tensor:
    """complex array -> planar (..., 2) float32 tensor."""
    return torch.as_tensor(planar_np(x))


def to_complex(x) -> np.ndarray:
    """planar (..., 2) -> host complex64."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    return (x[..., 0] + 1j * x[..., 1]).astype(np.complex64)


def planar_np(x) -> np.ndarray:
    x = np.asarray(x)
    return np.stack([x.real, x.imag], axis=-1).astype(np.float32)


def mul(a, b):
    """Elementwise complex multiply."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return torch.stack([ar * br - ai * bi, ar * bi + ai * br], dim=-1)


def conj_mul(a, b):
    """conj(a) * b elementwise."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return torch.stack([ar * br + ai * bi, ar * bi - ai * br], dim=-1)


def conj(a):
    return torch.stack([a[..., 0], -a[..., 1]], dim=-1)


def abs2(a):
    return a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1]


def absv(a):
    return torch.sqrt(abs2(a))


def scale(a, s):
    """Multiply by a real scalar/tensor broadcast over the planar axis."""
    return a * torch.as_tensor(s, dtype=a.dtype, device=a.device)[..., None]


def angle(a):
    return torch.atan2(a[..., 1], a[..., 0])


def expi(theta):
    """exp(1j*theta) -> planar."""
    return torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)


def normalize(a, eps: float = 1e-30):
    """a / |a| elementwise."""
    return a * torch.rsqrt(torch.clamp(abs2(a), min=eps))[..., None]


def dot(a, b, axis: int = -2):
    """Complex dot: sum over `axis` of a*b (planar in, planar out)."""
    return torch.sum(mul(a, b), dim=axis)


def conj_dot(a, b, axis: int = -2):
    """sum over `axis` of conj(a)*b."""
    return torch.sum(conj_mul(a, b), dim=axis)


def matmul(a, b):
    """Complex matmul via one packed real matmul.

    a: (..., M, K, 2), b: (K, N, 2) -> (..., M, N, 2).
    [Cr | Ci] = [Ar | Ai] @ [[Br, Bi], [-Bi, Br]].
    """
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    a2 = torch.cat([ar, ai], dim=-1)
    b2 = torch.cat([torch.cat([br, bi], dim=-1),
                    torch.cat([-bi, br], dim=-1)], dim=-2)
    c2 = a2 @ b2
    n = br.shape[-1]
    return torch.stack([c2[..., :n], c2[..., n:]], dim=-1)


@lru_cache(maxsize=None)
def _dft_matrix(n: int, sign: float) -> np.ndarray:
    """Planar DFT matrix (n, n, 2): W[j, k] = exp(sign*2j*pi*j*k/n)."""
    j, k = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    w = sign * 2.0 * np.pi * j * k / n
    return np.stack([np.cos(w), np.sin(w)], axis=-1).astype(np.float32)


def dft(x, inverse: bool = False):
    """Dense DFT along axis -2 of planar x (..., N, 2) as f32 matmuls.

    Matches np.fft.fft (no normalization; inverse carries 1/N)."""
    n = x.shape[-2]
    w = consts.table(_dft_matrix, n, 1.0 if inverse else -1.0,
                     device=x.device)
    xr, xi = x[..., 0], x[..., 1]
    wr, wi = w[..., 0], w[..., 1]
    yr = xr @ wr - xi @ wi
    yi = xr @ wi + xi @ wr
    y = torch.stack([yr, yi], dim=-1)
    if inverse:
        y = y / n
    return y
