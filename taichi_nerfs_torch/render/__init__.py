"""Renderers: the shear-warp frustum sweep and its serving front end."""
