"""Architecture configs of the port (copies of ``repro.configs``, with the
reference's shape cells)."""
