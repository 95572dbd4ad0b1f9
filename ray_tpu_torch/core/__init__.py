"""Process-wide configuration of the port (``config.Config``)."""
