"""The error of a run that cannot give a result."""


class RunError(Exception):
    """A run that cannot give a result: it prints none and exits with
    another code than 0."""
