"""Tuning: the blocksize rule and the knob words the resilience ladder
reads (``knobs.COMM_PRECISIONS``, ``knobs.LU_PANELS``)."""
from .policy import blocksize_policy
from .knobs import COMM_PRECISIONS, LU_PANELS
