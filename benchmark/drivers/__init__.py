"""Traffic drivers: one general generator per kind of traffic."""
