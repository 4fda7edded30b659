"""Mesh of ranks and the collectives over it."""
