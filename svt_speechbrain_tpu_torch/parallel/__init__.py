"""Multi-process helpers of the port (counterpart of ``svt_speechbrain_tpu.parallel``)."""
