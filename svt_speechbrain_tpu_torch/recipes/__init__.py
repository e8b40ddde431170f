"""Training recipes of the port (counterparts of the repository's ``recipes/``)."""
