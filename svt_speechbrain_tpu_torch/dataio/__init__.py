"""Data loading of the port (counterpart of ``svt_speechbrain_tpu.dataio``)."""
