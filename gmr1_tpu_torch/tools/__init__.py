"""Command-line drivers (counterparts of the repo's tools/gmr1_*.py), run
as modules:

    python -m gmr1_tpu_torch.tools.gmr1_rach_gen out.cfile SB_MASK PAYLOAD
    python -m gmr1_tpu_torch.tools.gmr1_gen_mat
    python -m gmr1_tpu_torch.tools.gmr1_process_recording [--run] CAP...
"""
