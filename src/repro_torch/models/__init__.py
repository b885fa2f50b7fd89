"""The model stack of the port: parameter specs, layers, attention, the
decoder stack and the top-level model API (``repro.models`` trimmed to
the dense attention stack)."""
