"""Traffic kinds (``<kind>.py``: set-up, window and check of one kind of
work) and traffic mixes (``<mix>.json``: the parameters one kind reads)."""
