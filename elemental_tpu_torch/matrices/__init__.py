"""Matrix constructors of the QR slice."""
from .basic import identity
