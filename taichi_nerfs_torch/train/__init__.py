"""Training-side helpers (image metrics so far)."""
