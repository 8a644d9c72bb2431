"""GMR-1 L1 channel coders (counterpart of gmr1_tpu/l1/): BCCH, CCCH,
TCH3, FACCH3, FACCH9 and TCH9 so far.  Soft bits follow the osmocom
convention: positive = bit 0."""
