"""Host-side helpers of the port: the analytic FLOP count (``flops.py``)
and the wire's base85 armour (``armor.py``)."""
