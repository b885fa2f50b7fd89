"""Framework-neutral core of the port: schedules, profiles, experiments,
scenarios and summaries, copied from ``repro.core`` and trimmed to what
the vector runtime reads."""
