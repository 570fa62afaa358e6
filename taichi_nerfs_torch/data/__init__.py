"""Datasets: the base class, the procedural synthetic scenes and camera
rigs."""
