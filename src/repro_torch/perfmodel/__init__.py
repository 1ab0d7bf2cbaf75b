"""Analytical performance models of the paper's machine (``ntx``)."""
