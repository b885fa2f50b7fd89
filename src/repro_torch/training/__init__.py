"""Training utilities of the port (``repro.training`` trimmed to what the
planner uses: the AdamW optimizer)."""
