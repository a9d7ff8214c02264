"""The references that decide ``correct``: ``plain.py``, the default, and
any other module a configuration names (``"reference"``), each keeping the
contract that ``compare.py`` states; and the comparison of the timed
path's answers with the reference's (``compare.py``)."""
