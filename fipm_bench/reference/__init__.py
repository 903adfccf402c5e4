"""The plain reference of the benchmark: the matcher (`matcher.py`, on
`ops.py` and `geometry.py`) and the comparison that decides `correct`
(`compare.py`). It imports nothing of the port and nothing of JAX."""
