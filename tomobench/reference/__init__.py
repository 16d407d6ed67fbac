"""The plain reference (``chain``) and the comparison (``compare``)."""
