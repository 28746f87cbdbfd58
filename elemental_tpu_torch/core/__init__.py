"""Core: distributions, the virtual grid, DistMatrix, views, environment."""
