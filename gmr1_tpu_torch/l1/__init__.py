"""GMR-1 L1 channel coders (counterpart of gmr1_tpu/l1/, SURVEY.md §2.2).

Every coder is a stateless (or functionally-stateful, for TCH9's
inter-burst interleaver) pair of batched encode/decode functions over
torch tensors.  Soft bits follow the osmocom convention: positive = bit
0.  All shapes carry arbitrary leading batch axes.
"""

from . import bcch, ccch, facch3, facch9, rach, tch3, tch9, xch_dc12  # noqa: F401
