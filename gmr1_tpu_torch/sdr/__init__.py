"""PHY layer: burst catalog, pi4-CxPSK modem, FCCH sync (counterpart of
gmr1_tpu/sdr/)."""
