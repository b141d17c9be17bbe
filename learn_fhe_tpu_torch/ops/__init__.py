"""Modular arithmetic, NTT, gadget decomposition and CRT torus products."""
