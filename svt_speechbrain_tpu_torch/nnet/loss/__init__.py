"""Specialized losses (transducer lattice)."""
