"""What the CPU tests know of each model family, one file a family:
``<family>.py``, found by a configuration's ``family`` as its
``systems/<family>.py`` is."""
