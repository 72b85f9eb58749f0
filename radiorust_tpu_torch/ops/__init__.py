"""Device ops: the hand-written CUDA kernels' wrappers and their plain
PyTorch versions."""


def kernel_wrappers() -> list:
    """The nine kernels' wrappers.  Each counts in ``launches`` the
    launches of its kernel (on CUDA tensors; on CPU tensors it runs its
    plain version and counts nothing)."""
    from . import channelizer as och
    from . import filter as ofl
    from . import frontend as ofe
    from . import scan as osc
    return [ofe.decimate, ofe.fused_mix_decimate, ofl.fused_overlap_save,
            ofl.fused_filter_bank, ofl.fused_demod_filter,
            ofl.fused_filter_demod_filter, och.fused_pfb_demod,
            osc.slew_scan, osc.agc_scan]
