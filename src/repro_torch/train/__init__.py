"""Serving (``serve_step``) and training (``train_step``, ``loss``) steps of
the LM substrate."""
