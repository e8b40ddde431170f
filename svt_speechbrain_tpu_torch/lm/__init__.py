"""Language modelling (port of ``svt_speechbrain_tpu/lm``): ARPA reading,
the back-off n-gram LM, counting."""
