"""Entry points of the port: the one-card LM training launcher
(``launch/train.py``) and the analytic parameter and FLOP counts
(``launch/analytic.py``)."""
