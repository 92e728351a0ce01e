"""Entry points of the LM substrate (``serve``, ``train``)."""
