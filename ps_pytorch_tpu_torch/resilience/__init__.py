"""The resilience planes of the port: so far the backoff policy of the
Coordinator's mask wait (``retry.py``)."""
