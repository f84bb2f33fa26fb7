"""Model modules of the port, with the reference's state-dict names."""
