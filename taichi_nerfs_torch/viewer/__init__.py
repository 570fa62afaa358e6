"""The interactive viewer (``viewer/gui.py``), headless without a
display."""
