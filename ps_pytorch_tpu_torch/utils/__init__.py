"""Host-side helpers of the port: the analytic FLOP count (``flops.py``)."""
