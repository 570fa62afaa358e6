"""Tensor ops: resampling, SH encoding, the shear-warp sweep kernel, and
the NGP path's bit math, rays, encoders, marching and compositing."""
