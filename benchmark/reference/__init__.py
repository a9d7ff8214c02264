"""The plain reference that decides ``correct`` (``plain.py``) and the
comparison of the timed path's answers with it (``compare.py``)."""
