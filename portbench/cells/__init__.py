"""One module per traffic generator (a mix's ``generator`` key): its cell class, ``Cell``."""
