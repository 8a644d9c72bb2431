"""The benchmark of gmr1_tpu_torch: whole-band GMR-1 recordings through
the wideband receiver on one card (see run.py)."""
