"""Tensor ops: resampling, SH encoding and the shear-warp sweep kernel."""
