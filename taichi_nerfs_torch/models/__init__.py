"""Model parameterisations: MLP, the dense feature pyramid, the NGP field,
its occupancy grid and the model registry."""
