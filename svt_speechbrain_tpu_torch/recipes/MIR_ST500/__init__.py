"""The MIR-ST500 audio AMT recipe (port of ``recipes/MIR_ST500``)."""
