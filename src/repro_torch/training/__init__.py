"""Training of the port (copy of ``repro.training``): the synthetic data
stream, AdamW and the train step."""
