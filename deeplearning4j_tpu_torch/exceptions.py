"""Exceptions of the port (counterparts of the JAX package's
``exceptions.py`` entries the ported modules raise)."""


class DL4JException(Exception):
    """Base of the framework's exceptions."""


class DL4JInvalidConfigException(DL4JException, ValueError):
    """A configuration that cannot be built or run."""



class DL4JFaultException(DL4JException):
    """A runtime fault (a process group that cannot be formed or is
    formed twice, a lost peer)."""
