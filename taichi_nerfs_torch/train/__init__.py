"""Training: the shear-warp trainer, the NGP trainer (state, step, loop,
eval), the shared Adam and the image metrics."""
