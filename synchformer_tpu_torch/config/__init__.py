"""Config loading and sanity checks (the port's copies of synchformer_tpu/config)."""
