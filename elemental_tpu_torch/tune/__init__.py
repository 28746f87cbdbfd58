"""Tuning: only the blocksize rule is ported so far."""
from .policy import blocksize_policy
