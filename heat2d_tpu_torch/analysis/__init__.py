"""The lock factories the threaded serve and resil modules take their
locks from (``analysis/locks.py``)."""
