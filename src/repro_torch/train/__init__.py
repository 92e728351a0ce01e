"""Serving steps of the LM substrate (``serve_step``); the training steps
come with the training slice."""
