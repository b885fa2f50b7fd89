"""Architecture configs of the port (copies of ``repro.configs``, without
the TPU dry-run's shape cells)."""
