"""Model configurations the port runs (``base.get_config`` /
``base.get_smoke_config``)."""
