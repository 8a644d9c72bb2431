"""Global PHY constants (reference include/osmocom/gmr1/sdr/defs.h:33)."""

SYM_RATE = 23_400  # GMR-1 symbol rate (symbols/s), one per 31.25 kHz carrier
