"""Task brains of the port (counterpart of ``svt_speechbrain_tpu.tasks``)."""
