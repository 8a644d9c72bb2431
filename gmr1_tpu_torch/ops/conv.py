"""GMR-1 convolutional code family (ETSI TS 101 376-5-3 4.4).

Counterpart of gmr1_tpu/ops/conv.py.  The generator polynomials are the
source of truth and the trellis tables are derived on the host:

  state  s  = the K-1 most recent input bits, bit j of s being the input
              from j+1 steps ago (LSB = most recent);
  step      : reg = (s << 1) | b; next state = reg & (2^(K-1) - 1);
  output    : bit i of the output symbol is parity(reg & g_i), g0 at MSB.

Encoding is (bits @ G) mod 2 with the host GF(2) generator matrix, in
float32 (0/1 operands, exact).  Decoding lives in viterbi.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property, lru_cache

import numpy as np
import torch

# full float32 matmuls, as everywhere in the port (TF32 rounds the
# operands to 10 mantissa bits)
torch.backends.cuda.matmul.allow_tf32 = False

TERM_FLUSH = "flush"
TERM_TAIL_BITING = "tail_biting"


@dataclass(frozen=True)
class ConvCode:
    """A rate-1/N constraint-K convolutional code + termination mode."""

    name: str
    k: int
    polys: tuple[int, ...]  # tap masks, bit i = D^i, poly[0] = g0
    term: str = TERM_FLUSH

    @property
    def n(self) -> int:
        return len(self.polys)

    @property
    def num_states(self) -> int:
        return 1 << (self.k - 1)

    def out_len(self, in_len: int) -> int:
        extra = self.k - 1 if self.term == TERM_FLUSH else 0
        return (in_len + extra) * self.n

    @cached_property
    def tables(self) -> tuple[np.ndarray, np.ndarray]:
        """(next_state[S,2], next_output[S,2]) — reference conv.c layout."""
        s = np.arange(self.num_states)
        mask = self.num_states - 1
        ns = np.empty((self.num_states, 2), dtype=np.int32)
        no = np.empty((self.num_states, 2), dtype=np.int32)
        for b in (0, 1):
            reg = (s << 1) | b
            ns[:, b] = reg & mask
            out = np.zeros_like(s)
            for g in self.polys:
                v = reg & g
                par = np.zeros_like(v)
                while np.any(v):
                    par ^= v & 1
                    v >>= 1
                out = (out << 1) | par
            no[:, b] = out
        return ns, no

    @cached_property
    def output_bits(self) -> np.ndarray:
        """next_output unpacked to bits: (S, 2, N), index 0 = g0."""
        _, no = self.tables
        shifts = np.arange(self.n - 1, -1, -1)
        return ((no[..., None] >> shifts) & 1).astype(np.uint8)


def _mask(*taps: int) -> int:
    m = 0
    for t in taps:
        m |= 1 << t
    return m


# generator polynomials from the spec (reference src/l1/conv.c comments)
K5_12 = ConvCode("k5_12", 5, (_mask(0, 3, 4), _mask(0, 1, 2, 4)))
K5_13 = ConvCode("k5_13", 5, (_mask(0, 2, 4), _mask(0, 1, 3, 4), _mask(0, 1, 2, 3, 4)))
K5_14 = ConvCode(
    "k5_14", 5,
    (_mask(0, 3, 4), _mask(0, 1, 2, 4), _mask(0, 2, 4), _mask(0, 1, 2, 3, 4)),
)
K5_15 = ConvCode(
    "k5_15", 5,
    (_mask(0, 2, 4), _mask(0, 1, 3, 4), _mask(0, 1, 2, 3, 4),
     _mask(0, 2, 3, 4), _mask(0, 1, 2, 4)),
)
K6_14 = ConvCode(
    "k6_14", 6,
    (_mask(0, 2, 5), _mask(0, 2, 3, 5), _mask(0, 1, 3, 4, 5),
     _mask(0, 1, 2, 3, 4, 5)),
)
K9_12 = ConvCode(
    "k9_12", 9, (_mask(0, 2, 3, 4, 8), _mask(0, 1, 2, 3, 5, 7, 8))
)
K9_13 = ConvCode(
    "k9_13", 9,
    (_mask(0, 2, 3, 5, 6, 7, 8), _mask(0, 1, 3, 4, 7, 8), _mask(0, 1, 2, 5, 8)),
)
# g3 follows the reference's table (conv.c:440-505), not its comment
K9_14 = ConvCode(
    "k9_14", 9,
    (_mask(0, 3, 4, 5, 7, 8), _mask(0, 2, 5, 7, 8), _mask(0, 1, 3, 4, 5, 8),
     _mask(0, 1, 2, 3, 4, 6, 8)),
)
TCH3_K7 = ConvCode(
    "tch3_k7", 7, (_mask(0, 2, 3, 5, 6), _mask(0, 1, 2, 3, 6)),
    term=TERM_TAIL_BITING,
)

ALL_CODES = (K5_12, K5_13, K5_14, K5_15, K6_14, K9_12, K9_13, K9_14, TCH3_K7)


@lru_cache(maxsize=None)
def _encode_matrix(code: ConvCode, in_len: int) -> np.ndarray:
    """GF(2) generator matrix G[in_len, out_len]: input bit i feeds tap j
    of generator n at output time i + j (mod in_len when tail-biting)."""
    t_steps = in_len + (code.k - 1 if code.term == TERM_FLUSH else 0)
    g = np.zeros((in_len, t_steps * code.n), dtype=np.uint8)
    taps = np.array(
        [[(p >> j) & 1 for j in range(code.k)] for p in code.polys],
        dtype=np.uint8,
    )  # (N, K)
    i = np.arange(in_len)
    for j in range(code.k):
        t = (i + j) % in_len if code.term == TERM_TAIL_BITING else i + j
        for n in range(code.n):
            if taps[n, j]:
                g[i, t * code.n + n] ^= 1
    return g.astype(np.float32)


def encode_np(code: ConvCode, bits: np.ndarray) -> np.ndarray:
    """Host bit-serial encoder (table source of truth, used for tests/G)."""
    bits = np.asarray(bits, dtype=np.uint8)
    in_len = len(bits)
    ns, _ = code.tables
    obits = code.output_bits
    state = 0
    if code.term == TERM_TAIL_BITING:
        # start state = the last K-1 input bits (libosmocore convention):
        # bit 0 of the state is input[len-1], the most recent at wrap
        for b in bits[in_len - code.k + 1:]:
            state = ((state << 1) | int(b)) & (code.num_states - 1)
        seq = bits
    else:
        seq = np.concatenate([bits, np.zeros(code.k - 1, dtype=np.uint8)])
    out = np.empty(len(seq) * code.n, dtype=np.uint8)
    for t, b in enumerate(seq):
        out[t * code.n:(t + 1) * code.n] = obits[state, int(b)]
        state = ns[state, int(b)]
    return out


def encode(code: ConvCode, bits, in_len: int | None = None):
    """Batched encoder: bits (..., L) -> (..., out_len(L)) uint8."""
    bits = torch.as_tensor(bits)
    if in_len is None:
        in_len = bits.shape[-1]
    g = torch.as_tensor(_encode_matrix(code, in_len), device=bits.device)
    return torch.remainder(bits.to(torch.float32) @ g, 2.0).to(torch.uint8)
