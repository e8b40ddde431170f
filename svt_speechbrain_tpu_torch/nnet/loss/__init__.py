"""Specialized losses: the transducer lattice, guided attention, SI-SNR."""
