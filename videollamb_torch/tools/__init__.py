"""Weight-surgery tools (``weights.py``)."""
