"""Step builders of the port (``repro.train``): the serving steps."""
