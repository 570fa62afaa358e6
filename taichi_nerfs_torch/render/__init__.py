"""Renderers: the shear-warp frustum sweep and its serving front end, and
the NGP path's train- and test-time renderer."""
