"""Architecture configs of the port (``repro.configs`` trimmed to the
models the port runs)."""
