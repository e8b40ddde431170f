"""Signal processing (port of ``svt_speechbrain_tpu/processing``)."""
