"""Experiment-tracking integrations (the port's copy of
``ray_tpu/air/integrations/``; parity: ``python/ray/air/integrations/``)."""
