"""Parameter conversion, the deployment exports, visualisation helpers."""
