"""Entry points of the model zoo: serving (``serve``) and ``make_batch``."""
