"""Parameter conversion and visualisation helpers."""
