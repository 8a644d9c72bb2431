"""GMR-1 L1 channel coders (counterpart of gmr1_tpu/l1/): BCCH and CCCH
so far.  Soft bits follow the osmocom convention: positive = bit 0."""
