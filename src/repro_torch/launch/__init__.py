"""Entry points of the port (``repro.launch``)."""
