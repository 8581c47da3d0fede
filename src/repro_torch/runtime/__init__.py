"""The restarting training supervisor (``supervisor``)."""
