"""Training data streams (port of ``repro.data``)."""
