"""Model parameterisations (MLP, TruncExp, dense feature pyramid)."""
