"""Camera rigs (numpy)."""
