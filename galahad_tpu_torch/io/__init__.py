"""File interfaces of the port: the QPLIB reader and writer (``qplib``) and
the SIF decoder (``sif``)."""
from . import qplib, sif  # noqa: F401
