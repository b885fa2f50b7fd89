"""Serving: the continuous-batching inference engine and its stub."""
