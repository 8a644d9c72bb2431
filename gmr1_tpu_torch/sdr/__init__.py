"""PHY layer: burst catalog, pi4-CxPSK modem, FCCH sync, DKAB
(counterpart of gmr1_tpu/sdr/)."""
